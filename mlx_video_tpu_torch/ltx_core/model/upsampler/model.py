"""Upsampler model re-export (reference: ltx_core/model/upsampler/model.py)."""

from mlx_video_tpu_torch.models.ltx.upsampler import (
    init_latent_upsampler,
    latent_upsampler_apply,
    upsample_latents,
)

from mlx_video_tpu_torch.ltx_core.model.upsampler import LatentUpsampler


def upsample_video(latent, params):
    """Run the 2x latent upsampler on ``latent`` (reference: model.py:6-8)."""
    return latent_upsampler_apply(params, latent)


__all__ = [
    "LatentUpsampler",
    "init_latent_upsampler",
    "latent_upsampler_apply",
    "upsample_latents",
    "upsample_video",
]
