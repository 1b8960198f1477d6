"""Seconds from the process's start to the window's: imports, weights drawn
on the card, the program built over them, the kernels loaded (built on a
checkout's first run), the warm-up call."""


def read(ctx):
    return ctx.get("setup_s")
