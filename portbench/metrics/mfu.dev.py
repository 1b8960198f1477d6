"""The whole step's share of the card's bf16 peak, per cent: the model
operations of the traced slices (portbench/flops.py: the DiT's linears at
the doubled batch, caption K/V included, self- and cross-attention) over
their wall times 989 TFLOP/s."""

from portbench.readers import mfu


def read(ctx):
    return mfu(ctx, "dev_step")
