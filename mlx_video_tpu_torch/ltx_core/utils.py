"""Velocity/denoised conversions: fp32 islands, the input's dtype restored.

Counterpart of ltx_core/utils.py (reference ltx_core/utils.py).
"""

from __future__ import annotations

import torch

from mlx_video_tpu_torch.ops.norms import rms_norm  # noqa: F401  (re-export)


def get_device() -> torch.device:
    """The CUDA device the parity packages run on; raises without one. Every
    ``device=None`` in ltx_core, ltx_pipelines and ltx_trainer means this
    device: pass ``device="cpu"`` to run on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("get_device: CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def device_or_card(device) -> torch.device:
    """``device``, or the card (:func:`get_device`) when it is None."""
    return get_device() if device is None else torch.device(device)


def _sigma_f32(sigma, like: torch.Tensor) -> torch.Tensor:
    s = torch.as_tensor(sigma, dtype=torch.float32, device=like.device)
    while s.dim() < like.dim():
        s = s[..., None]
    return s


def to_denoised(sample: torch.Tensor, velocity: torch.Tensor, sigma) -> torch.Tensor:
    """x0 = x_t - sigma * v (fp32 island)."""
    out = sample.float() - _sigma_f32(sigma, sample) * velocity.float()
    return out.to(sample.dtype)


def to_velocity(sample: torch.Tensor, denoised_sample: torch.Tensor, sigma) -> torch.Tensor:
    """v = (x_t - x0) / sigma (fp32 island)."""
    out = (sample.float() - denoised_sample.float()) / _sigma_f32(sigma, sample)
    return out.to(sample.dtype)
