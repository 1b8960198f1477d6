"""Device milliseconds a dev step of the GEMM class (cuBLAS and CUTLASS
kernels: ops/linear.py's linears and the plain text cross-attention's
products)."""

from portbench.readers import class_ms


def read(ctx):
    return class_ms(ctx, "dev_step", "gemm")
