"""The whole call's share of the card's bf16 peak, per cent: the model
operations of the traced calls (portbench/flops.py: the DiT's linears,
caption K/V included, self- and cross-attention, the upsampler's and the
decoder's convolutions) over their wall times 989 TFLOP/s."""

from portbench.readers import mfu


def read(ctx):
    return mfu(ctx, "video")
