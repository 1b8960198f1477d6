"""K2's share of its roofline, per cent: the least time of the block
linears' work in the traced calls (portbench/roofline/k2.py at each
linear's shape, counted from the model, whatever ran it) over the device
time of quant_matmul_kernel. Nothing to read on a dense configuration or
where no K2 kernel ran."""

from portbench.readers import kernel_seconds
from portbench.roofline import bound_s, k2


def read(ctx):
    q = ctx.get("cfg", {}).get("quant")
    t = kernel_seconds(ctx, k2.KERNEL)
    if ctx.get("unit") != "video" or not q or t <= 0:
        return None
    scale_bytes = 2 if q["scale_dtype"] == "bfloat16" else 4
    least = sum(c * bound_s(*k2.work(m, k, n, q["bits"], q["group_size"], scale_bytes))
                for m, k, n, c in ctx["work"]["block_linears"])
    return 100.0 * least * ctx["units"] / t
