"""Device operations launched a dev step in the traced calls (kernels,
copies and sets), from the profiler's trace: the host's dispatch work."""

from portbench.readers import per_unit


def read(ctx):
    return per_unit(ctx, "dev_step", ctx.get("launches"))
