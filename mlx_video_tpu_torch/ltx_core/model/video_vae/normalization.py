"""Normalization re-export (reference: ltx_core/model/video_vae/normalization.py)."""

from mlx_video_tpu_torch.ltx_core.model.common.normalization import PixelNorm, build_normalization_layer

__all__ = ["PixelNorm", "build_normalization_layer"]
