"""LTX-2 video VAE encoder, on NCDHW tensors.

Counterpart of mlx_video_tpu/models/ltx/video_vae/encoder.py
(``init_video_encoder``, ``video_encoder_apply``, ``encode_image``). The
encoder is built from the configuration's ``encoder_blocks`` list; the
default (``VideoVAEConfig``):

  patchify(4) 3 -> 48 channels, conv_in 48 -> 128
  4x ResBlock(128) -> space-to-depth (1,2,2) -> 256 -> 6x ResBlock(256) ->
  (2,1,1) -> 512 -> 6x ResBlock(512) -> (2,2,2) -> 1024 -> 2x ResBlock(1024)
  -> (2,2,2) -> 2048 -> 2x ResBlock(2048)
  pixel_norm -> SiLU -> conv_out 2048 -> 129 (128 means + one shared log-var)

It takes (B, 3, 1 + 8k, H, W) video in [-1, 1] and returns the normalised
latent means (B, 128, 1 + k, H/32, W/32); the log-variance channel is
dropped. The JAX package's per-block ``_chunked`` and channels-last ``_cl``
variants work around TPU compile times and are not ported.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from mlx_video_tpu_torch.config import VideoVAEConfig
from mlx_video_tpu_torch.models.ltx.video_vae import ops
from mlx_video_tpu_torch.models.ltx.video_vae.blocks import (
    ResnetBlock3D,
    SpaceToDepthDownsample,
    pixel_norm,
    resnet_block,
    space_to_depth_downsample,
)
from mlx_video_tpu_torch.models.ltx.video_vae.conv import Conv3d, causal_conv3d, init_conv_

_STRIDES = {
    "compress_all_res": (2, 2, 2),
    "compress_space_res": (1, 2, 2),
    "compress_time_res": (2, 1, 1),
    "compress_all": (2, 2, 2),
    "compress_space": (1, 2, 2),
    "compress_time": (2, 1, 1),
    "compress_all_x_y": (2, 2, 2),
}
_SPACE_TO_DEPTH = ("compress_all_res", "compress_space_res", "compress_time_res")
_STRIDED_CONV = ("compress_all", "compress_space", "compress_time", "compress_all_x_y")


def _block_channels(name: str, cfg: Dict[str, Any], in_ch: int) -> int:
    """Output channels of an encoder block."""
    if name in ("compress_all_res", "compress_space_res", "compress_time_res", "compress_all_x_y", "res_x_y"):
        return in_ch * cfg.get("multiplier", 2)
    return in_ch


class ResBlockGroup(nn.Module):
    def __init__(self, channels: int, num_layers: int, device=None, dtype=None):
        super().__init__()
        self.res_blocks = nn.ModuleList(ResnetBlock3D(channels, device=device, dtype=dtype) for _ in range(num_layers))


class LatentStatistics(nn.Module):
    """The per-channel latent mean and std (fp32 buffers)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("std", torch.ones(channels, device=device))


class VideoEncoder(nn.Module):
    """Encoder parameters under the JAX pytree's names."""

    def __init__(self, config: VideoVAEConfig = VideoVAEConfig(), device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        feat = config.out_channels
        self.conv_in = Conv3d(config.in_channels * config.patch_size**2, feat, 3, **kw)
        self.per_channel_statistics = LatentStatistics(config.out_channels, device=device)
        blocks: dict = {}
        for i, (name, cfg) in enumerate(config.encoder_blocks):
            out_ch = _block_channels(name, cfg, feat)
            if name == "res_x":
                blocks[str(i)] = ResBlockGroup(feat, cfg["num_layers"], **kw)
            elif name == "res_x_y":
                blocks[str(i)] = ResnetBlock3D(feat, out_ch, **kw)
            elif name in _SPACE_TO_DEPTH:
                blocks[str(i)] = SpaceToDepthDownsample(feat, out_ch, _STRIDES[name], **kw)
            elif name in _STRIDED_CONV:
                blocks[str(i)] = Conv3d(feat, out_ch, 3, **kw)
            else:
                raise ValueError(f"Unknown encoder block: {name}")
            feat = out_ch
        self.down_blocks = nn.ModuleDict(blocks)
        self.conv_out = Conv3d(feat, config.out_channels + 1, 3, **kw)


def init_video_encoder(
    generator: torch.Generator, config: VideoVAEConfig = VideoVAEConfig(), device=None, dtype=torch.float32
) -> VideoEncoder:
    """Build the encoder and draw its weights on ``device`` (the JAX
    ``init_video_encoder`` init: uniform convs, zero biases, mean 0 and std 1
    statistics)."""
    if device is None:
        device = generator.device
    encoder = VideoEncoder(config, device=device, dtype=dtype)
    with torch.no_grad():
        for module in encoder.modules():
            if isinstance(module, Conv3d):
                init_conv_(module, generator)
    return encoder


def video_encoder_apply(
    encoder: VideoEncoder,
    config: VideoVAEConfig,
    sample: torch.Tensor,
    padding_mode: str = "zeros",
) -> torch.Tensor:
    """Encode (B, C, F, H, W) video in [-1, 1] to normalised latent means
    (B, latent_C, F', H', W')."""
    frames = sample.shape[2]
    if (frames - 1) % 8 != 0:
        raise ValueError(f"Encode input must have 1 + 8*k frames (e.g. 1, 9, 17, ...); got {frames}.")
    x = ops.patchify(sample, patch_size_hw=config.patch_size, patch_size_t=1)
    x = causal_conv3d(encoder.conv_in, x, 3, 1, True, padding_mode)
    feat = config.out_channels
    for i, (name, cfg) in enumerate(config.encoder_blocks):
        block = encoder.down_blocks[str(i)]
        out_ch = _block_channels(name, cfg, feat)
        if name == "res_x":
            for res in block.res_blocks:
                x = resnet_block(res, x, True, padding_mode)
        elif name == "res_x_y":
            x = resnet_block(block, x, True, padding_mode)
        elif name in _SPACE_TO_DEPTH:
            x = space_to_depth_downsample(block, x, out_ch, _STRIDES[name], True, padding_mode)
        else:
            x = causal_conv3d(block, x, 3, _STRIDES[name], True, padding_mode)
        feat = out_ch
    x = causal_conv3d(encoder.conv_out, F.silu(pixel_norm(x)), 3, 1, True, padding_mode)
    stats = encoder.per_channel_statistics
    return ops.normalize_latents(x[:, : config.out_channels], stats.mean, stats.std)


def encode_image(
    encoder: VideoEncoder, config: VideoVAEConfig, image: torch.Tensor, padding_mode: str = "zeros"
) -> torch.Tensor:
    """Encode an (H, W, 3) or (B, H, W, 3) image in [0, 1] to a one-frame
    latent (B, latent_C, 1, H/32, W/32)."""
    if image.dim() == 3:
        image = image[None]
    x = (image * 2.0 - 1.0).permute(0, 3, 1, 2)[:, :, None]
    return video_encoder_apply(encoder, config, x, padding_mode)
