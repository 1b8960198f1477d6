"""Sigma schedulers: LTX2, LinearQuadratic, Beta (numpy schedules).

Behavioral spec: reference ltx_core/components/schedulers.py:16-107. The
LTX2 math is shared with mlx_video_tpu_torch.pipelines.schedulers.ltx2_scheduler.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from mlx_video_tpu_torch.pipelines.schedulers import (
    BASE_SHIFT_ANCHOR,
    MAX_SHIFT_ANCHOR,
    ltx2_scheduler,
)

from mlx_video_tpu_torch.ltx_core.components.protocols import SchedulerProtocol  # noqa: F401 (parity export)


class LTX2Scheduler:
    """Token-count-shifted sigma schedule (reference: schedulers.py:16-54)."""

    def execute(
        self,
        steps: int,
        latent=None,
        max_shift: float = 2.05,
        base_shift: float = 0.95,
        stretch: bool = True,
        terminal: float = 0.1,
        **_kwargs,
    ) -> np.ndarray:
        tokens = int(np.prod(latent.shape[2:])) if latent is not None else MAX_SHIFT_ANCHOR
        return ltx2_scheduler(
            steps, num_tokens=tokens, max_shift=max_shift, base_shift=base_shift,
            stretch=stretch, terminal=terminal,
        )


class LinearQuadraticScheduler:
    """Linear then quadratic schedule (reference: schedulers.py:57-80)."""

    def execute(
        self, steps: int, threshold_noise: float = 0.025, linear_steps=None, **_kwargs
    ) -> np.ndarray:
        if steps == 1:
            return np.array([1.0, 0.0], dtype=np.float32)
        if linear_steps is None:
            linear_steps = steps // 2
        linear = [i * threshold_noise / linear_steps for i in range(linear_steps)]
        diff = linear_steps - threshold_noise * steps
        quadratic_steps = steps - linear_steps
        quadratic = []
        if quadratic_steps > 0:
            qc = diff / (linear_steps * quadratic_steps**2)
            lc = threshold_noise / linear_steps - 2 * diff / (quadratic_steps**2)
            const = qc * (linear_steps**2)
            quadratic = [qc * i**2 + lc * i + const for i in range(linear_steps, steps)]
        schedule = [1.0 - x for x in linear + quadratic + [1.0]]
        return np.asarray(schedule, dtype=np.float32)


def flux_time_shift(mu: float, sigma: float, t: float) -> float:
    return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)


@lru_cache(maxsize=5)
def _model_sampling_sigmas(shift: float, timesteps_length: int):
    timesteps = np.arange(1, timesteps_length + 1) / timesteps_length
    return np.array([flux_time_shift(shift, 1.0, t) for t in timesteps])


class BetaScheduler:
    """Beta-distribution timestep selection (reference: schedulers.py:83-107)."""

    shift = 2.37
    timesteps_length = 10000

    def execute(self, steps: int, alpha: float = 0.6, beta: float = 0.6) -> np.ndarray:
        import scipy.stats

        sigmas = _model_sampling_sigmas(self.shift, self.timesteps_length)
        total = len(sigmas) - 1
        ts = 1 - np.linspace(0, 1, steps, endpoint=False)
        ts = np.rint(scipy.stats.beta.ppf(ts, alpha, beta) * total).tolist()
        ts = list(dict.fromkeys(ts))
        return np.asarray([float(sigmas[int(t)]) for t in ts] + [0.0], dtype=np.float32)
