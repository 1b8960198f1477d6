"""Conditioning items (reference: ltx_core/conditioning/*)."""

from mlx_video_tpu_torch.pipelines.conditioning import (
    LatentState as PipelineLatentState,
    apply_conditioning,
    apply_denoise_mask,
    create_initial_state,
)

from mlx_video_tpu_torch.ltx_core.conditioning.types import (
    VideoConditionByKeyframeIndex,
    VideoConditionByLatentIndex,
)


class ConditioningError(ValueError):
    """(reference: ltx_core/conditioning/exceptions.py)."""


def __getattr__(name):
    # ConditioningItem lives in ltx_core.conditioning.item (imported lazily to
    # avoid a circular import with ltx_core.types at package init)
    if name == "ConditioningItem":
        from mlx_video_tpu_torch.ltx_core.conditioning.item import ConditioningItem

        return ConditioningItem
    raise AttributeError(name)
