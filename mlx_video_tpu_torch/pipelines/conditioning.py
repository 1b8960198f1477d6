"""Latent-space conditioning for image-to-video and keyframes.

Counterpart of mlx_video_tpu/pipelines/conditioning.py:

- ``VideoConditionByLatentIndex`` (replace mode): overwrite latent frames
  with the clean conditioning latent and set their denoise mask to
  ``1 - strength``.
- ``VideoConditionByKeyframeIndex`` (guide mode): keep the noisy latent, set
  the clean reference and the mask only.
- ``LatentState`` carries (latent, clean_latent, per-frame denoise_mask); the
  per-step blend is ``denoised * mask + clean * (1 - mask)``.

Noise comes from a ``torch.Generator`` (fp32 draws, cast to the latent's
dtype) or is given as a tensor; the JAX functions take keys. Tensors are
never updated in place: each function returns new ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple, Union

import torch


@dataclass
class VideoConditionByLatentIndex:
    """Replace-mode conditioning."""

    latent: torch.Tensor  # (B, C, f, H, W)
    frame_idx: int = 0
    strength: float = 1.0

    def get_num_latent_frames(self) -> int:
        return self.latent.shape[2]


@dataclass
class VideoConditionByKeyframeIndex:
    """Guide-mode conditioning."""

    keyframes: torch.Tensor  # (B, C, f, H, W)
    frame_idx: int = 0
    strength: float = 1.0

    def get_num_latent_frames(self) -> int:
        return self.keyframes.shape[2]


VideoCondition = Union[VideoConditionByLatentIndex, VideoConditionByKeyframeIndex]


class LatentState(NamedTuple):
    """(latent, clean_latent, per-frame denoise mask)."""

    latent: torch.Tensor  # (B, C, F, H, W)
    clean_latent: torch.Tensor  # (B, C, F, H, W)
    denoise_mask: torch.Tensor  # (B, 1, F, 1, 1); 1.0 = denoise, 0.0 = keep clean


def _normal(shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
    draw = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return draw.to(device=device, dtype=dtype)


def create_initial_state(
    shape: Tuple[int, ...],
    generator: Optional[torch.Generator] = None,
    noise_scale: float = 1.0,
    dtype=torch.float32,
    device=None,
    noise: Optional[torch.Tensor] = None,
) -> LatentState:
    """Initial state: latent = noise * noise_scale (zeros without a generator
    or ``noise``), clean latent zeros, denoise mask ones."""
    if noise is None:
        noise = torch.zeros(shape, dtype=dtype, device=device) if generator is None else \
            _normal(shape, generator, dtype, device)
    else:
        noise = noise.to(device=device, dtype=dtype)
    return LatentState(
        latent=noise * noise_scale,
        clean_latent=torch.zeros(shape, dtype=dtype, device=noise.device),
        denoise_mask=torch.ones((shape[0], 1, shape[2], 1, 1), dtype=dtype, device=noise.device),
    )


def apply_conditioning(state: LatentState, conditionings: List[VideoCondition]) -> LatentState:
    """Place conditioning latents and masks at their frame indices."""
    latent, clean, mask = state.latent.clone(), state.clean_latent.clone(), state.denoise_mask.clone()
    _, c, f, h, w = latent.shape

    for cond in conditionings:
        if isinstance(cond, VideoConditionByKeyframeIndex):
            cond_latent, replace = cond.keyframes, False
        else:
            cond_latent, replace = cond.latent, True
        frame_idx, strength = cond.frame_idx, cond.strength

        _, cc, cf, ch, cw = cond_latent.shape
        if (cc, ch, cw) != (c, h, w):
            raise ValueError(
                f"Conditioning latent shape ({cc}, {ch}, {cw}) does not match target ({c}, {h}, {w})"
            )
        if frame_idx >= f:
            raise ValueError(f"Frame index {frame_idx} is out of bounds for latent with {f} frames")

        end = min(frame_idx + cf, f)
        cond_slice = cond_latent[:, :, : end - frame_idx].to(device=latent.device, dtype=latent.dtype)
        if replace:
            latent[:, :, frame_idx:end] = cond_slice
        clean[:, :, frame_idx:end] = cond_slice
        mask[:, :, frame_idx:end] = 1.0 - strength

    return LatentState(latent=latent, clean_latent=clean, denoise_mask=mask)


def apply_denoise_mask(denoised: torch.Tensor, clean: torch.Tensor, denoise_mask: torch.Tensor) -> torch.Tensor:
    """denoised * mask + clean * (1 - mask), in denoised's dtype."""
    mask = denoise_mask.to(denoised.dtype)
    return denoised * mask + clean.to(denoised.dtype) * (1.0 - mask)


def add_noise_with_state(
    state: LatentState,
    noise_scale: float,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> LatentState:
    """Mask-scaled renoising: latent = noise * s * mask + latent * (1 - s * mask),
    with ``noise`` given or drawn in fp32 from ``generator``."""
    dtype, device = state.latent.dtype, state.latent.device
    if noise is None:
        if generator is None:
            raise ValueError("add_noise_with_state needs a generator or a noise tensor")
        noise = _normal(state.latent.shape, generator, torch.float32, device)
    noise = noise.to(device=device, dtype=dtype)
    effective = noise_scale * state.denoise_mask.to(dtype)
    return state._replace(latent=noise * effective + state.latent * (1.0 - effective))
