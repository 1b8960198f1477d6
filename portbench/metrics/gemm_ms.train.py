"""Device milliseconds a training step of the GEMM class (cuBLAS and
CUTLASS: the linears forward, recomputed and backward, the LoRA products,
the plain text attention's)."""

from portbench.readers import class_ms


def read(ctx):
    return class_ms(ctx, "train_step", "gemm")
