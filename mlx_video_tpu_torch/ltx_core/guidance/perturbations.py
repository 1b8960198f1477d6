"""STG attention-perturbation configs (reference:
ltx_core/guidance/perturbations.py). The masks are tensors on the caller's
device (the card when None) and dtype."""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Optional

import torch

from mlx_video_tpu_torch.ltx_core.utils import device_or_card


class PerturbationType(Enum):
    SKIP_A2V_CROSS_ATTN = "skip_a2v_cross_attn"
    SKIP_V2A_CROSS_ATTN = "skip_v2a_cross_attn"
    SKIP_VIDEO_SELF_ATTN = "skip_video_self_attn"
    SKIP_AUDIO_SELF_ATTN = "skip_audio_self_attn"


@dataclass(frozen=True)
class Perturbation:
    type: PerturbationType
    blocks: Optional[List[int]]

    def is_perturbed(self, perturbation_type: PerturbationType, block: int) -> bool:
        if self.type != perturbation_type:
            return False
        return self.blocks is None or block in self.blocks


@dataclass(frozen=True)
class PerturbationConfig:
    perturbations: Optional[List[Perturbation]]

    def is_perturbed(self, perturbation_type: PerturbationType, block: int) -> bool:
        if self.perturbations is None:
            return False
        return any(p.is_perturbed(perturbation_type, block) for p in self.perturbations)

    @staticmethod
    def empty() -> "PerturbationConfig":
        return PerturbationConfig([])


@dataclass(frozen=True)
class BatchedPerturbationConfig:
    perturbations: List[PerturbationConfig]

    def mask(self, perturbation_type: PerturbationType, block: int, dtype=torch.float32,
             device=None) -> torch.Tensor:
        values = [0.0 if p.is_perturbed(perturbation_type, block) else 1.0 for p in self.perturbations]
        return torch.tensor(values, dtype=dtype, device=device_or_card(device))

    def mask_like(self, perturbation_type: PerturbationType, block: int, values: torch.Tensor) -> torch.Tensor:
        mask = self.mask(perturbation_type, block, values.dtype, values.device)
        return mask.reshape((mask.shape[0],) + (1,) * (values.dim() - 1))

    def any_in_batch(self, perturbation_type: PerturbationType, block: int) -> bool:
        return any(p.is_perturbed(perturbation_type, block) for p in self.perturbations)

    def all_in_batch(self, perturbation_type: PerturbationType, block: int) -> bool:
        return all(p.is_perturbed(perturbation_type, block) for p in self.perturbations)

    @staticmethod
    def empty(batch_size: int) -> "BatchedPerturbationConfig":
        return BatchedPerturbationConfig([PerturbationConfig.empty() for _ in range(batch_size)])
