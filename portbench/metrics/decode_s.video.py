"""Seconds of the upsample and the VAE decode a video: generate_video's
phase_seconds upsample + vae_decode over the traced calls' videos."""

from portbench.readers import per_unit


def read(ctx):
    p = ctx.get("phases", {})
    if "vae_decode" not in p:
        return None
    return per_unit(ctx, "video", p.get("upsample", 0.0) + p["vae_decode"])
