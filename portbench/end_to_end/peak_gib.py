"""Peak device memory over the window, GiB: torch.cuda.max_memory_allocated
after reset_peak_memory_stats at the window's start (resident weights count,
set-up transients do not)."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30 if ctx.get("peak_bytes") else None
