"""Device milliseconds a video of the GEMM class (cuBLAS and CUTLASS
kernels; ops/linear.py's dense linears and the plain attention's
products)."""

from portbench.readers import class_ms


def read(ctx):
    return class_ms(ctx, "video", "gemm")
