"""VAE ops re-export (reference: ltx_core/model/video_vae/ops.py). The
port's VAE runs channels-first throughout, so it has no counterpart of the
JAX ``to_channels_first``/``to_channels_last`` layout moves."""

from mlx_video_tpu_torch.models.ltx.video_vae.ops import (
    denormalize_latents,
    normalize_latents,
    patchify,
    unpatchify,
)

__all__ = [
    "denormalize_latents",
    "normalize_latents",
    "patchify",
    "unpatchify",
]
