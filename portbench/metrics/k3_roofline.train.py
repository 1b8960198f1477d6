"""K3's share of its roofline, per cent: the least time of the traced
steps' attention backward at (1, 3456, 32, 128) (portbench/roofline/k3.py,
counted from the model) over the device time of the flash_bwd kernels.
Nothing to read where no K3 kernel ran."""

from portbench.readers import kernel_seconds
from portbench.roofline import bound_s, k3


def read(ctx):
    t = kernel_seconds(ctx, k3.KERNEL)
    if ctx.get("unit") != "train_step" or t <= 0:
        return None
    least = sum(n * bound_s(*k3.work(s, h, d)) for s, h, d, n in ctx["work"]["flash_bwd"])
    return 100.0 * least * ctx["units"] / t
