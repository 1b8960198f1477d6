"""2x latent spatial upsampler, on NCDHW tensors.

Counterpart of mlx_video_tpu/models/ltx/upsampler.py: conv3d 128->1024 +
GroupNorm/SiLU, 4 ResBlock3D, per-frame 2D conv + pixel-shuffle 2x, 4 post
ResBlock3D, conv3d 1024->128. ``upsample_latents`` runs it on de-normalised
latents and re-normalises the result.

ResBlock order: conv -> norm -> SiLU, conv -> norm, then SiLU after the
residual add.

Row split (``rows``, video_vae/conv.py): the upsampler runs on this rank's
rows of H. Each 3-D and per-frame 2-D conv takes one halo row from each
neighbour in place of its zero padding of H (zeros stay at the global
edges); GroupNorm sums its statistics over ``rows`` (video_vae/blocks.py:
group_norm); the pixel shuffle is local along H.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mlx_video_tpu_torch.models.ltx.video_vae.blocks import AffineNorm, group_norm
from mlx_video_tpu_torch.models.ltx.video_vae.conv import Conv2d, Conv3d, init_conv_, spatial_pad


def _conv3d_same(conv: Conv3d, x: torch.Tensor, rows=None) -> torch.Tensor:
    """3x3x3 conv with symmetric zero padding (H by halo rows under a row
    split); bias added in fp32."""
    if rows is not None and rows.size > 1:
        out = F.conv3d(spatial_pad(x, 1, 0, "zeros", rows), conv.weight.to(x.dtype), padding=(1, 0, 1))
    else:
        out = F.conv3d(x, conv.weight.to(x.dtype), padding=1)
    return (out.float() + conv.bias.float().reshape(1, -1, 1, 1, 1)).to(x.dtype)


class ResBlock3D(nn.Module):
    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = Conv3d(channels, channels, 3, **kw)
        self.norm1 = AffineNorm(channels, **kw)
        self.conv2 = Conv3d(channels, channels, 3, **kw)
        self.norm2 = AffineNorm(channels, **kw)


def res_block_3d(block: ResBlock3D, x: torch.Tensor, rows=None) -> torch.Tensor:
    """conv/norm/silu -> conv/norm -> silu(x + residual); GroupNorm eps 1e-5."""
    h = F.silu(group_norm(block.norm1, _conv3d_same(block.conv1, x, rows), 32, eps=1e-5, rows=rows))
    h = group_norm(block.norm2, _conv3d_same(block.conv2, h, rows), 32, eps=1e-5, rows=rows)
    return F.silu(h + x)


class SpatialUpsampler(nn.Module):
    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        self.conv = Conv2d(channels, 4 * channels, 3, device=device, dtype=dtype)


def spatial_upsample_2x(ups: SpatialUpsampler, x: torch.Tensor, rows=None) -> torch.Tensor:
    """Per-frame 3x3 conv then pixel shuffle 2x: (B, C, F, H, W) ->
    (B, C, F, 2H, 2W), PixelShuffle channel order."""
    b, c, f, h, w = x.shape
    padding = 1
    if rows is not None and rows.size > 1:
        x, padding = spatial_pad(x, 1, 0, "zeros", rows), (0, 1)
    x2 = x.transpose(1, 2).reshape(b * f, c, x.shape[3], w)
    x2 = F.conv2d(x2, ups.conv.weight.to(x.dtype), ups.conv.bias.to(x.dtype), padding=padding)
    x2 = F.pixel_shuffle(x2, 2)
    return x2.reshape(b, f, c, 2 * h, 2 * w).transpose(1, 2)


class LatentUpsampler(nn.Module):
    def __init__(self, in_channels: int = 128, mid_channels: int = 1024, num_blocks: int = 4,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.initial_conv = Conv3d(in_channels, mid_channels, 3, **kw)
        self.initial_norm = AffineNorm(mid_channels, **kw)
        self.res_blocks = nn.ModuleList(ResBlock3D(mid_channels, **kw) for _ in range(num_blocks))
        self.upsampler = SpatialUpsampler(mid_channels, **kw)
        self.post_upsample_res_blocks = nn.ModuleList(ResBlock3D(mid_channels, **kw) for _ in range(num_blocks))
        self.final_conv = Conv3d(mid_channels, in_channels, 3, **kw)


def init_latent_upsampler(
    generator: torch.Generator,
    in_channels: int = 128,
    mid_channels: int = 1024,
    num_blocks: int = 4,
    device=None,
    dtype=torch.float32,
) -> LatentUpsampler:
    """Build the upsampler and draw its weights on ``device``: uniform convs
    with zero bias, GroupNorm weight 1 and bias 0."""
    if device is None:
        device = generator.device
    ups = LatentUpsampler(in_channels, mid_channels, num_blocks, device=device, dtype=dtype)
    with torch.no_grad():
        for module in ups.modules():
            if isinstance(module, (Conv3d, Conv2d)):
                init_conv_(module, generator)
            elif isinstance(module, AffineNorm):
                module.reset_()
    return ups


def latent_upsampler_apply(ups: LatentUpsampler, latent: torch.Tensor, rows=None) -> torch.Tensor:
    """(B, C, F, H, W) -> (B, C, F, 2H, 2W); under a row split (``rows``)
    this rank's rows in and out."""
    x = F.silu(group_norm(ups.initial_norm, _conv3d_same(ups.initial_conv, latent, rows), 32, eps=1e-5, rows=rows))
    for block in ups.res_blocks:
        x = res_block_3d(block, x, rows)
    x = spatial_upsample_2x(ups.upsampler, x, rows)
    for block in ups.post_upsample_res_blocks:
        x = res_block_3d(block, x, rows)
    return _conv3d_same(ups.final_conv, x, rows)


def upsample_latents(
    ups: LatentUpsampler, latent: torch.Tensor, latent_mean: torch.Tensor, latent_std: torch.Tensor, rows=None,
) -> torch.Tensor:
    """De-normalise -> upsample -> re-normalise, in the latent dtype;
    ``rows``: the row split of the module docstring."""
    mean = latent_mean.reshape(1, -1, 1, 1, 1).to(latent.dtype)
    std = latent_std.reshape(1, -1, 1, 1, 1).to(latent.dtype)
    up = latent_upsampler_apply(ups, latent * std + mean, rows)
    return (up - mean) / std
