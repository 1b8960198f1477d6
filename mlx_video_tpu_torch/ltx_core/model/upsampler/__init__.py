"""Upsampler re-exports (reference: ltx_core/model/upsampler/__init__.py).

``LatentUpsampler`` is the reference's class surface over the engine's
2x latent upsampler module (mlx_video_tpu_torch/models/ltx/upsampler.py),
binding one in place or drawing a fresh one on ``device`` (the card when
None) from ``generator``, which must lie there (seed 0 there when not given).
"""

import torch

from mlx_video_tpu_torch.ltx_core.utils import device_or_card
from mlx_video_tpu_torch.models.ltx.upsampler import (
    init_latent_upsampler,
    latent_upsampler_apply,
    upsample_latents,
)

from mlx_video_tpu_torch.ltx_core.model.upsampler.pixel_shuffle import pixel_shuffle_2d


class LatentUpsamplerConfigurator:
    """Compat configurator (reference: upsampler/__init__.py:6-8)."""

    def __init__(self, *_, **__):
        pass


class LatentUpsampler:
    """Class-style adapter over the 2x latent upsampler."""

    def __init__(self, params=None, *, generator=None, dtype=None, device=None, **init_kw):
        if params is None:
            device = device_or_card(device)
            generator = generator if generator is not None else torch.Generator(device).manual_seed(0)
            params = init_latent_upsampler(generator, device=device, dtype=dtype or torch.float32, **init_kw)
        self.params = params

    def __call__(self, latent):
        return latent_upsampler_apply(self.params, latent)


__all__ = [
    "LatentUpsampler",
    "LatentUpsamplerConfigurator",
    "init_latent_upsampler",
    "latent_upsampler_apply",
    "pixel_shuffle_2d",
    "upsample_latents",
]
