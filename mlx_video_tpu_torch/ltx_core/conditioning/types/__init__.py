"""Conditioning item types (reference: ltx_core/conditioning/types/__init__.py).
The classes extend the engine dataclasses with the reference's token-domain
``apply_to`` protocol."""

from mlx_video_tpu_torch.ltx_core.conditioning.types.keyframe_cond import VideoConditionByKeyframeIndex
from mlx_video_tpu_torch.ltx_core.conditioning.types.latent_cond import VideoConditionByLatentIndex

__all__ = ["VideoConditionByKeyframeIndex", "VideoConditionByLatentIndex"]
