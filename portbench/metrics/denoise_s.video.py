"""Seconds of both denoise stages a video: generate_video's phase_seconds
stage1_denoise + stage2_denoise (each ended by a synchronise) over the
traced calls' videos."""

from portbench.readers import per_unit


def read(ctx):
    p = ctx.get("phases", {})
    if "stage1_denoise" not in p:
        return None
    return per_unit(ctx, "video", p["stage1_denoise"] + p.get("stage2_denoise", 0.0))
