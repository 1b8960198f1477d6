"""Seconds per video: the window's wall over the videos its calls completed."""


def read(ctx):
    if ctx.get("unit") != "video" or not ctx.get("units"):
        return None
    return ctx["window_s"] / ctx["units"]
