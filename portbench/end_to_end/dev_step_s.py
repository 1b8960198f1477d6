"""Seconds per dev step: the window's wall over the guided steps its calls
completed."""


def read(ctx):
    if ctx.get("unit") != "dev_step" or not ctx.get("units"):
        return None
    return ctx["window_s"] / ctx["units"]
