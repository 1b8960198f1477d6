"""Seconds per training step: the window's wall over the steps its
train() call completed (the call's final save included)."""


def read(ctx):
    if ctx.get("unit") != "train_step" or not ctx.get("units"):
        return None
    return ctx["window_s"] / ctx["units"]
