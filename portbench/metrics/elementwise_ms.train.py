"""Device milliseconds a training step of the kernels outside every named
class (portbench/trace.py: elementwise, norms, softmax, casts, copies, the
optimizer's): the fp32 islands forward, recomputed and backward."""

from portbench.readers import class_ms


def read(ctx):
    return class_ms(ctx, "train_step", "other")
