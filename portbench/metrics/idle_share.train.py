"""Per cent of the traced call's wall in which no operation ran on the
card (1 - busy / wall)."""

from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx, "train_step")
