"""Euler diffusion step (reference: ltx_core/components/diffusion_steps.py)."""

from __future__ import annotations

import torch

from mlx_video_tpu_torch.ltx_core.utils import to_velocity


class EulerDiffusionStep:
    def execute(
        self, sample: torch.Tensor, denoised_sample: torch.Tensor, sigmas, step_index: int
    ) -> torch.Tensor:
        velocity = to_velocity(sample, denoised_sample, sigmas[step_index])
        dt = torch.as_tensor(sigmas[step_index + 1] - sigmas[step_index], dtype=torch.float32,
                             device=sample.device)
        out = sample.float() + velocity.float() * dt
        return out.to(sample.dtype)
