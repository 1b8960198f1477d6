"""Conditioning exceptions (reference: ltx_core/conditioning/exceptions.py)."""

from mlx_video_tpu_torch.ltx_core.conditioning import ConditioningError

__all__ = ["ConditioningError"]
