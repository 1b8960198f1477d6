"""Gaussian noiser (reference: ltx_core/components/noisers.py).

The draws are explicit: call ``n`` of ``GaussianNoiser(seed)`` draws from a
``torch.Generator`` on the latents' device seeded from ``(seed, n)`` alone,
as the trainer seeds a step's draws (trainer/trainer.py:step_generator),
in fp32, cast to the latents' dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from mlx_video_tpu_torch.trainer.trainer import step_generator


@dataclass
class GaussianNoiser:
    seed: Optional[int] = None
    _counter: int = 0

    def noise(self, latents: torch.Tensor) -> torch.Tensor:
        g = step_generator(self.seed if self.seed is not None else 0, self._counter, latents.device)
        self._counter += 1
        draw = torch.randn(latents.shape, generator=g, device=latents.device, dtype=torch.float32)
        return draw.to(latents.dtype)
