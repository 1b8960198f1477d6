"""K1's share of its roofline, per cent: the least time of the traced
slices' self-attention at (2, 5184, 32, 128) (portbench/roofline/k1.py,
counted from the model) over the device time of flash_fwd_kernel. Nothing
to read where no K1 kernel ran."""

from portbench.readers import kernel_seconds
from portbench.roofline import bound_s, k1


def read(ctx):
    t = kernel_seconds(ctx, k1.KERNEL)
    if ctx.get("unit") != "dev_step" or t <= 0:
        return None
    least = sum(n * bound_s(*k1.work(b, s, h, d)) for b, s, h, d, n in ctx["work"]["self_attention"])
    return 100.0 * least * ctx["units"] / t
