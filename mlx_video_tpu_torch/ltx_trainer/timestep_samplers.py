"""Timestep samplers (reference: ltx_trainer/timestep_samplers.py ->
mlx_video/mlx_trainer/timestep_samplers.py:10-55).

The engine path is ``sample_sigmas`` over an explicit generator
(mlx_video_tpu_torch/trainer/strategies.py). These classes present the
reference's stateful ``sample_for(latents, seq_len)`` API on it: a sampler
seeds a ``torch.Generator`` from ``seed`` on the first call's latents'
device (the card for latents that are not a tensor) and draws from it, so
its stream advances per call and a new sampler
of the same seed repeats it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from mlx_video_tpu_torch.ltx_core.utils import get_device
from mlx_video_tpu_torch.trainer.strategies import sample_sigmas  # noqa: F401


@dataclass
class TimestepSampler:
    """Base class for sampling sigmas/timesteps. Prefer
    ``get_timestep_sampler`` over the shared ``SAMPLERS`` instances when
    reproducibility matters: shared instances share one stream across
    callers."""

    seed: int = 0

    def _generator(self, device) -> torch.Generator:
        g = getattr(self, "_gen", None)
        if g is None:
            g = self._gen = torch.Generator(device=device).manual_seed(self.seed)
        return g

    def _draw(self, latents, seq_len: Optional[int], mode: str, std: float = 1.0) -> torch.Tensor:
        b = latents.shape[0]
        device = latents.device if isinstance(latents, torch.Tensor) else get_device()
        sigmas = sample_sigmas(self._generator(device), b, seq_len or latents.shape[1], mode, std)
        return sigmas.reshape(b, 1, 1).to(device)

    def sample_for(self, latents, seq_len: Optional[int] = None):
        raise NotImplementedError


@dataclass
class UniformSampler(TimestepSampler):
    def sample_for(self, latents, seq_len: Optional[int] = None):
        return self._draw(latents, seq_len, "uniform")


@dataclass
class ShiftedLogitNormalSampler(TimestepSampler):
    std: float = 1.0

    def sample_for(self, latents, seq_len: Optional[int] = None):
        return self._draw(latents, seq_len, "shifted_logit_normal", self.std)


SAMPLERS: Dict[str, TimestepSampler] = {
    "uniform": UniformSampler(),
    "shifted_logit_normal": ShiftedLogitNormalSampler(),
}


def get_timestep_sampler(mode: str, std: float = 1.0) -> TimestepSampler:
    if mode == "shifted_logit_normal":
        return ShiftedLogitNormalSampler(std=std)
    return UniformSampler()
