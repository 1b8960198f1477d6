"""Norms, resnet block, space-to-depth downsample and depth-to-space upsample
for the video VAE (NCDHW).

Counterpart of mlx_video_tpu/models/ltx/video_vae/blocks.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from mlx_video_tpu_torch.models.ltx.video_vae.conv import Conv3d, causal_conv3d


def pixel_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-position RMS norm over the channel dim (dim 1), fp32 island."""
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, dim=1, keepdim=True) + eps)).to(x.dtype)


class AffineNorm(nn.Module):
    """Parameter holder for :func:`group_norm`: per-channel weight and bias."""

    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device, dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(channels, device=device, dtype=dtype), requires_grad=False)

    def reset_(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()


def group_norm(norm: AffineNorm, x: torch.Tensor, num_groups: int = 32, eps: float = 1e-6,
               rows=None) -> torch.Tensor:
    """GroupNorm over (B, C, ...) with statistics and affine in fp32. Under
    a row split (``rows``: x holds this rank's rows of H) the group's fp32
    sum, then its sum of squares about the mean, are summed over ``rows``,
    so every rank normalises by the whole tensor's statistics."""
    if rows is None or rows.size == 1:
        out = F.group_norm(x.float(), num_groups, norm.weight.float(), norm.bias.float(), eps)
        return out.to(x.dtype)
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    count = xf.shape[-1] * rows.size
    mean = rows.all_reduce(xf.sum(-1, keepdim=True)) / count
    centered = xf - mean
    var = rows.all_reduce((centered * centered).sum(-1, keepdim=True)) / count
    out = (centered * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    out = out * norm.weight.float().reshape(shape) + norm.bias.float().reshape(shape)
    return out.to(x.dtype)


class ResnetBlock3D(nn.Module):
    """Encoder-style resnet block: conv1, conv2 and a 1x1 shortcut when the
    channel count changes."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        out_channels = out_channels or in_channels
        kw = dict(device=device, dtype=dtype)
        self.conv1 = Conv3d(in_channels, out_channels, 3, **kw)
        self.conv2 = Conv3d(out_channels, out_channels, 3, **kw)
        if in_channels != out_channels:
            self.shortcut = Conv3d(in_channels, out_channels, 1, **kw)


def resnet_block(
    block: ResnetBlock3D,
    x: torch.Tensor,
    causal: bool = True,
    padding_mode: str = "zeros",
    eps: float = 1e-6,
) -> torch.Tensor:
    """PixelNorm -> SiLU -> conv, twice, plus the (1x1 conv) shortcut."""
    h = causal_conv3d(block.conv1, F.silu(pixel_norm(x, eps)), 3, 1, causal, padding_mode)
    h = causal_conv3d(block.conv2, F.silu(pixel_norm(h, eps)), 3, 1, causal, padding_mode)
    residual = x
    if hasattr(block, "shortcut"):
        residual = causal_conv3d(block.shortcut, x, 1, 1, causal, padding_mode)
    return h + residual


def _space_to_depth(x: torch.Tensor, stride: Tuple[int, int, int]) -> torch.Tensor:
    """b c (d st) (h sh) (w sw) -> b (c st sh sw) d h w."""
    st, sh, sw = stride
    return rearrange(x, "b c (d st) (h sh) (w sw) -> b (c st sh sw) d h w", st=st, sh=sh, sw=sw)


class SpaceToDepthDownsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: Tuple[int, int, int], device=None, dtype=None):
        super().__init__()
        mult = stride[0] * stride[1] * stride[2]
        self.conv = Conv3d(in_channels, out_channels // mult, 3, device=device, dtype=dtype)


def space_to_depth_downsample(
    ds: SpaceToDepthDownsample,
    x: torch.Tensor,
    out_channels: int,
    stride: Tuple[int, int, int],
    causal: bool = True,
    padding_mode: str = "zeros",
) -> torch.Tensor:
    """3x3 conv then space-to-depth, plus a skip: the space-to-depth input
    averaged over contiguous groups of channels. A temporal downsample first
    repeats the first frame (causal alignment); ragged dimensions are
    zero-padded up to the stride."""
    st, sh, sw = stride
    c, d, h, w = x.shape[1:]
    group_size = c * st * sh * sw // out_channels
    if st == 2:
        x = torch.cat([x[:, :, :1], x], dim=2)
        d += 1
    pads = ((sw - w % sw) % sw, (sh - h % sh) % sh, (st - d % st) % st)
    if any(pads):
        x = F.pad(x, (0, pads[0], 0, pads[1], 0, pads[2]))
    skip = _space_to_depth(x, stride)
    skip = skip.reshape(skip.shape[0], out_channels, group_size, *skip.shape[2:]).mean(dim=2)
    return _space_to_depth(causal_conv3d(ds.conv, x, 3, 1, causal, padding_mode), stride) + skip


def _depth_to_space(x: torch.Tensor, stride: Tuple[int, int, int]) -> torch.Tensor:
    """b (c st sh sw) d h w -> b c (d st) (h sh) (w sw)."""
    st, sh, sw = stride
    return rearrange(x, "b (c st sh sw) d h w -> b c (d st) (h sh) (w sw)", st=st, sh=sh, sw=sw)


class DepthToSpaceUpsample(nn.Module):
    def __init__(self, in_channels: int, stride: Tuple[int, int, int],
                 out_channels_reduction_factor: int = 1, device=None, dtype=None):
        super().__init__()
        mult = stride[0] * stride[1] * stride[2]
        out_channels = in_channels // out_channels_reduction_factor
        self.conv = Conv3d(in_channels, out_channels * mult, 3, device=device, dtype=dtype)


def depth_to_space_upsample(
    ups: DepthToSpaceUpsample,
    x: torch.Tensor,
    stride: Tuple[int, int, int],
    residual: bool = False,
    out_channels_reduction_factor: int = 1,
    causal: bool = True,
    padding_mode: str = "zeros",
    rows=None,
) -> torch.Tensor:
    """Conv to C*prod(stride) channels, 3D pixel shuffle, optional tiled
    residual; a temporal upsample drops the first frame. The shuffle is
    local along H (row i becomes rows sh*i .. sh*i + sh - 1), so under a row
    split (``rows``) only the conv exchanges halos."""
    st, sh, sw = stride
    h = _depth_to_space(causal_conv3d(ups.conv, x, 3, 1, causal, padding_mode, rows), stride)
    if st > 1:
        h = h[:, :, 1:]
    if residual:
        x_residual = _depth_to_space(x, stride)
        x_residual = x_residual.repeat(1, (st * sh * sw) // out_channels_reduction_factor, 1, 1, 1)
        if st > 1:
            x_residual = x_residual[:, :, 1:]
        h = h + x_residual
    return h
