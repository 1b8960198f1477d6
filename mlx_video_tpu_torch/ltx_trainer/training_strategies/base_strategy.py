"""Training-strategy protocol (reference:
ltx_trainer/training_strategies/base_strategy.py ->
mlx_video/mlx_trainer/training_strategies/base_strategy.py:17-55).

The engine path is plain functions (prepare_* -> draw_inputs -> make_inputs
-> compute_loss, mlx_video_tpu_torch/trainer/strategies.py);
``TrainingStrategy`` presents the reference's class protocol on them. Its
draws come from a ``torch.Generator`` seeded from the config's ``seed``
(on the batch's device at the first call) that advances per call, or from
the ``generator`` a caller passes. The batch goes to ``device`` (the card
when None).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from mlx_video_tpu_torch.trainer.strategies import (  # noqa: F401
    ModelInputs,
    StrategyBatch,
    compute_loss,
    draw_inputs,
    make_inputs,
)
from mlx_video_tpu_torch.ltx_core.utils import device_or_card


class TrainingStrategy:
    """Protocol: requires_audio / get_data_sources /
    prepare_training_inputs / compute_loss."""

    #: override in subclasses: (batch, device) -> StrategyBatch
    _prepare = None
    _sources: Any = {"latents": "latents", "conditions": "conditions"}

    def __init__(self, cfg: Any = None) -> None:
        self.cfg = cfg
        self._gen: Optional[torch.Generator] = None

    @property
    def requires_audio(self) -> bool:
        return bool(getattr(self.cfg, "with_audio", False))

    def get_data_sources(self):
        return dict(self._sources)

    def _generator(self, device) -> torch.Generator:
        if self._gen is None:
            self._gen = torch.Generator(device=device).manual_seed(int(getattr(self.cfg, "seed", 0) or 0))
        return self._gen

    def prepare_training_inputs(
        self, batch, timestep_sampler=None, generator: Optional[torch.Generator] = None, device=None,
        dtype=torch.float32,
    ) -> ModelInputs:
        if type(self)._prepare is None:
            raise NotImplementedError
        sb = type(self)._prepare(batch, device=device_or_card(device))
        if generator is None:
            # the strategy's own stream advances per call (a fixed draw here
            # would train every step on the same sigma and noise)
            generator = self._generator(sb.video_latents.device)
        cfg = self.cfg
        # an explicitly passed sampler's distribution wins over the config
        # fields (the engine path, trainer/strategies.py)
        mode = getattr(cfg, "timestep_sampling_mode", "uniform")
        std = getattr(cfg, "timestep_sampling_std", 1.0)
        if timestep_sampler is not None:
            name = type(timestep_sampler).__name__
            if "ShiftedLogitNormal" in name:
                mode = "shifted_logit_normal"
                std = getattr(timestep_sampler, "std", std)
            elif "Uniform" in name:
                mode = "uniform"
        draws = draw_inputs(
            sb,
            generator,
            first_frame_conditioning_p=getattr(cfg, "first_frame_conditioning_p", 0.1),
            timestep_sampling_mode=mode,
            timestep_sampling_std=std,
        )
        return make_inputs(sb, draws, dtype=dtype)

    def compute_loss(self, video_pred, audio_pred, inputs: ModelInputs):
        return compute_loss(video_pred, inputs, audio_pred)


__all__ = [
    "ModelInputs",
    "StrategyBatch",
    "TrainingStrategy",
    "compute_loss",
    "make_inputs",
]
