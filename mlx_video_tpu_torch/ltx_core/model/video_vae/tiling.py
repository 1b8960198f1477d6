"""Tiling re-export (reference: ltx_core/model/video_vae/tiling.py)."""

from mlx_video_tpu_torch.models.ltx.video_vae.tiling import (
    SpatialTilingConfig,
    TemporalTilingConfig,
    TilingConfig,
    compute_trapezoidal_mask_1d,
    decode_with_tiling,
    map_spatial_slice,
    map_temporal_slice,
    split_in_spatial,
    split_in_temporal,
)

__all__ = [
    "SpatialTilingConfig",
    "TemporalTilingConfig",
    "TilingConfig",
    "compute_trapezoidal_mask_1d",
    "decode_with_tiling",
    "map_spatial_slice",
    "map_temporal_slice",
    "split_in_spatial",
    "split_in_temporal",
]
