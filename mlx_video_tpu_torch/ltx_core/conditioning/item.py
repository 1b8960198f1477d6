"""ConditioningItem protocol (reference: ltx_core/conditioning/item.py)."""

from __future__ import annotations

from typing import Protocol

from mlx_video_tpu_torch.ltx_core.types import LatentState


class ConditioningItem(Protocol):
    """Anything that can apply itself to a latent state
    (reference: ltx_core/conditioning/item.py)."""

    def apply_to(self, latent_state: LatentState, latent_tools) -> LatentState: ...


__all__ = ["ConditioningItem", "LatentState"]
