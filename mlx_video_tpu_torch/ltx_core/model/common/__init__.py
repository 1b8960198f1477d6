"""Common model utilities (reference: ltx_core/model/common/__init__.py)."""

from mlx_video_tpu_torch.ltx_core.model.common.normalization import (
    NormType,
    PixelNorm,
    build_normalization_layer,
    pixel_norm,
)

__all__ = ["NormType", "PixelNorm", "build_normalization_layer", "pixel_norm"]
