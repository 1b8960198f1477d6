"""Distilled denoising loop (video-only, no CFG), as a plain Python loop.

Counterpart of the distilled branch of mlx_video_tpu/pipelines/denoise.py:
denoise. Each step runs the DiT on the flattened latents, forms the
denoised estimate x0 = x_t - sigma * v and takes an fp32 Euler step; the
last step (sigma_next = 0) reduces to x0.

Not ported yet: CFG, conditioning state, audio, the caching dials and the
parallel forwards.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from mlx_video_tpu_torch.config import LTXModelConfig
from mlx_video_tpu_torch.models.ltx import rope as rope_lib
from mlx_video_tpu_torch.models.ltx.model import LTXModel, Modality, ltx_apply, to_denoised


def flatten_video_latents(latents: torch.Tensor) -> torch.Tensor:
    """(B, C, F, H, W) -> (B, F*H*W, C) token layout."""
    b, c = latents.shape[0], latents.shape[1]
    return latents.reshape(b, c, -1).transpose(1, 2)


def unflatten_video_latents(tokens: torch.Tensor, shape) -> torch.Tensor:
    """(B, S, C) -> (B, C, F, H, W)."""
    b, c, f, h, w = shape
    return tokens.transpose(1, 2).reshape(b, c, f, h, w)


def video_timesteps_mask(shape, dtype, device=None) -> torch.Tensor:
    """Denoise mask without conditioning state: every token shares one
    sigma, so the mask is (B, 1) ones and the adaLN modulation stays
    per-batch. (The JAX function also takes the conditioning state, which
    is not ported yet.)"""
    return torch.ones((shape[0], 1), dtype=dtype, device=device)


def precompute_video_pe(config: LTXModelConfig, positions: torch.Tensor):
    return rope_lib.precompute_freqs_cis(
        positions,
        dim=config.inner_dim,
        theta=config.positional_embedding_theta,
        max_pos=config.positional_embedding_max_pos,
        use_middle_indices_grid=config.use_middle_indices_grid,
        num_attention_heads=config.num_attention_heads,
        rope_type=config.rope_type,
        double_precision=config.double_precision_rope,
    )


def _euler_step(latents: torch.Tensor, denoised: torch.Tensor, sigma: float, sigma_next: float) -> torch.Tensor:
    """fp32 Euler update; exact at sigma_next = 0."""
    lat = latents.float()
    den = denoised.float()
    return (den + sigma_next * (lat - den) / sigma).to(latents.dtype)


def denoise(
    model: LTXModel,
    config: LTXModelConfig,
    latents: torch.Tensor,
    positions: torch.Tensor,
    context: torch.Tensor,
    sigmas: Sequence[float],
) -> torch.Tensor:
    """Run the distilled sigma schedule over (B, C, F, H, W) latents.

    ``positions`` is the (B, 3, F*H*W, 2) pixel-space grid; ``context`` the
    (B, S_ctx, caption_channels) text embeddings. Returns the final latents.
    """
    sig = [float(s) for s in np.asarray(sigmas, dtype=np.float32)]
    pe = precompute_video_pe(config, positions)
    mask = video_timesteps_mask(latents.shape, latents.dtype, latents.device)
    shape = latents.shape
    for sigma, sigma_next in zip(sig[:-1], sig[1:]):
        velocity = ltx_apply(
            model, config,
            Modality(
                latent=flatten_video_latents(latents),
                timesteps=(sigma * mask).to(latents.dtype),
                context=context,
                pe=pe,
            ),
        )
        denoised = to_denoised(latents, unflatten_video_latents(velocity, shape), sigma)
        latents = _euler_step(latents, denoised, sigma, sigma_next)
    return latents
