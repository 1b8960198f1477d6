"""The whole step's share of the card's bf16 peak, per cent: the model
operations of the traced steps (the forward and the backward a LoRA step
needs, recompute not counted; drivers/lora_train.py:work) over their wall
times 989 TFLOP/s."""

from portbench.readers import mfu


def read(ctx):
    return mfu(ctx, "train_step")
