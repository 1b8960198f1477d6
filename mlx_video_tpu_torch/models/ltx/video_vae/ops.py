"""Patchify and per-channel latent statistics for the video VAE.

Counterpart of mlx_video_tpu/models/ltx/video_vae/ops.py, on channels-first
(B, C, F, H, W) tensors where the JAX package works channels-last. The
channel packing order is the same: within each source channel the packed
index runs (p, r, q) = (temporal, width, height) from slowest to fastest.
"""

from __future__ import annotations

import torch
from einops import rearrange


def patchify(x: torch.Tensor, patch_size_hw: int = 4, patch_size_t: int = 1) -> torch.Tensor:
    """(B, C, F*pt, H*q, W*r) -> (B, C*pt*r*q, F, H, W)."""
    return rearrange(
        x, "b c (f p) (h q) (w r) -> b (c p r q) f h w",
        p=patch_size_t, q=patch_size_hw, r=patch_size_hw,
    )


def unpatchify(x: torch.Tensor, patch_size_hw: int = 4, patch_size_t: int = 1) -> torch.Tensor:
    """Inverse of :func:`patchify`."""
    return rearrange(
        x, "b (c p r q) f h w -> b c (f p) (h q) (w r)",
        p=patch_size_t, q=patch_size_hw, r=patch_size_hw,
    )


def _per_channel(stat: torch.Tensor, ndim: int) -> torch.Tensor:
    return stat.float().reshape(1, -1, *([1] * (ndim - 2)))


def normalize_latents(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std per channel (dim 1), fp32 island."""
    return ((x.float() - _per_channel(mean, x.dim())) / _per_channel(std, x.dim())).to(x.dtype)


def denormalize_latents(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """x * std + mean per channel (dim 1), fp32 island."""
    return (x.float() * _per_channel(std, x.dim()) + _per_channel(mean, x.dim())).to(x.dtype)
