"""Antialiased blur-downsample (reference: ltx_core/model/upsampler/blur_downsample.py;
the reference's ``blur_down_kernel`` (ones(5, 5) / 25) on its
SpatialRationalResampler, whose forward pins the scale to 2 and never runs
it). Channels-first here, as every port module: x (N, C, H, W)."""

import torch
import torch.nn.functional as F


def blur_down(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """5x5 box blur with zero padding 2, then a stride-``factor`` subsample."""
    n, c, h, w = x.shape
    kernel = torch.full((1, 1, 5, 5), 1.0 / 25.0, dtype=x.dtype, device=x.device)
    out = F.conv2d(x.reshape(n * c, 1, h, w), kernel, stride=factor, padding=2)
    return out.reshape(n, c, out.shape[2], out.shape[3])


__all__ = ["blur_down"]
