"""Device milliseconds a dev step of the kernels outside every named class
(portbench/trace.py: elementwise, norms, softmax, casts, copies): the fp32
islands of ops/norms.py, models/ltx/rope.py and models/ltx/model.py."""

from portbench.readers import class_ms


def read(ctx):
    return class_ms(ctx, "dev_step", "other")
