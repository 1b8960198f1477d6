"""Device operations launched a training step in the traced call (kernels,
copies and sets), from the profiler's trace: the host's dispatch work."""

from portbench.readers import per_unit


def read(ctx):
    return per_unit(ctx, "train_step", ctx.get("launches"))
