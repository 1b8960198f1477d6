"""Modality re-export (reference: ltx_core/model/transformer/modality.py)."""

from mlx_video_tpu_torch.models.ltx.model import Modality

__all__ = ["Modality"]
