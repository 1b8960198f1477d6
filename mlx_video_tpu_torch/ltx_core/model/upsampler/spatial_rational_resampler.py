"""Rational resampler (reference: ltx_core/model/upsampler/spatial_rational_resampler.py):
the engine's per-frame conv and 2x pixel shuffle, then for a rational scale
2/q the blur-downsample by q. Channels-first: x (B, C, F, H, W)."""

import torch

from mlx_video_tpu_torch.models.ltx.upsampler import SpatialUpsampler, spatial_upsample_2x

from mlx_video_tpu_torch.ltx_core.model.upsampler.blur_downsample import blur_down


def spatial_rational_resample(ups: SpatialUpsampler, x: torch.Tensor, scale: float = 2.0) -> torch.Tensor:
    x2 = spatial_upsample_2x(ups, x)
    if scale == 2.0:
        return x2
    q = round(2.0 / scale)
    if abs(2.0 / q - scale) > 1e-6 or q < 1:
        raise ValueError(f"Unsupported rational scale {scale} (need 2/q)")
    if q == 1:
        return x2
    b, c, f, h, w = x2.shape
    frames = blur_down(x2.transpose(1, 2).reshape(b * f, c, h, w), factor=q)
    return frames.reshape(b, f, c, frames.shape[2], frames.shape[3]).transpose(1, 2)


__all__ = ["spatial_rational_resample"]
