"""LTX-2 video VAE decoder with timestep conditioning, on NCDHW tensors.

Counterpart of mlx_video_tpu/models/ltx/video_vae/decoder.py:
video_decoder_apply. Architecture (128 latent channels -> RGB):

  conv_in 128->1024
  [5x ResBlock(1024, ts-mod)] -> up(2,2,2) ->512 -> [5x ResBlock(512)] ->
  up ->256 -> [5x ResBlock(256)] -> up ->128 -> [5x ResBlock(128)]
  pixel_norm -> last-layer timestep modulation -> SiLU -> conv_out 128->48
  unpatchify(4) -> (B, 3, F, H, W)

Decode noise is given as a tensor or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mlx_video_tpu_torch.models.ltx.video_vae import ops
from mlx_video_tpu_torch.models.ltx.video_vae.blocks import (
    DepthToSpaceUpsample,
    depth_to_space_upsample,
    pixel_norm,
)
from mlx_video_tpu_torch.models.ltx.video_vae.conv import Conv3d, causal_conv3d, init_conv_
from mlx_video_tpu_torch.ops.linear import Linear, init_linear_, linear


class DecoderConfig(NamedTuple):
    """Geometry of the LTX-2 decoder (same fields as the JAX DecoderConfig)."""

    in_channels: int = 128
    out_channels: int = 3
    patch_size: int = 4
    num_layers_per_block: int = 5
    base_channels: int = 1024
    num_upsamples: int = 3
    padding_mode: str = "reflect"
    timestep_conditioning: bool = True
    decode_noise_scale: float = 0.025
    decode_timestep: float = 0.05

    @property
    def channel_schedule(self):
        """[1024, 512, 256, 128] for the default geometry."""
        return [self.base_channels // (2**i) for i in range(self.num_upsamples + 1)]


def _timestep_embedding_256(t: torch.Tensor) -> torch.Tensor:
    """Sinusoidal 256-dim embedding, cos first, fp32."""
    half = 128
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class TimeEmbedder(nn.Module):
    """256 -> dim -> dim MLP on the timestep sinusoid."""

    def __init__(self, embedding_dim: int, device=None, dtype=None):
        super().__init__()
        self.linear_1 = Linear(256, embedding_dim, device=device, dtype=dtype)
        self.linear_2 = Linear(embedding_dim, embedding_dim, device=device, dtype=dtype)


def time_embedder_apply(emb: TimeEmbedder, t: torch.Tensor, dtype) -> torch.Tensor:
    proj = _timestep_embedding_256(t).to(dtype)
    return linear(emb.linear_2, F.silu(linear(emb.linear_1, proj)))


class DecoderResBlock(nn.Module):
    def __init__(self, channels: int, ts_cond: bool, device=None, dtype=None):
        super().__init__()
        self.conv1 = Conv3d(channels, channels, 3, device=device, dtype=dtype)
        self.conv2 = Conv3d(channels, channels, 3, device=device, dtype=dtype)
        if ts_cond:
            self.scale_shift_table = nn.Parameter(
                torch.empty(4, channels, device=device, dtype=dtype), requires_grad=False
            )


class ResBlockGroup(nn.Module):
    def __init__(self, channels: int, config: DecoderConfig, device=None, dtype=None):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            DecoderResBlock(channels, config.timestep_conditioning, device, dtype)
            for _ in range(config.num_layers_per_block)
        )
        if config.timestep_conditioning:
            self.time_embedder = TimeEmbedder(channels * 4, device=device, dtype=dtype)


class VideoDecoder(nn.Module):
    """Decoder parameters, including the latent statistics ``latents_mean``
    and ``latents_std`` (fp32 buffers)."""

    def __init__(self, config: DecoderConfig = DecoderConfig(), device=None, dtype=None):
        super().__init__()
        chans = config.channel_schedule
        kw = dict(device=device, dtype=dtype)
        self.conv_in = Conv3d(config.in_channels, chans[0], 3, **kw)
        self.register_buffer("latents_mean", torch.zeros(config.in_channels, device=device))
        self.register_buffer("latents_std", torch.ones(config.in_channels, device=device))
        up: dict = {}
        for g, ch in enumerate(chans):
            up[str(2 * g)] = ResBlockGroup(ch, config, **kw)
            if g < config.num_upsamples:
                up[str(2 * g + 1)] = DepthToSpaceUpsample(ch, (2, 2, 2), 2, **kw)
        self.up_blocks = nn.ModuleDict(up)
        self.conv_out = Conv3d(chans[-1], config.out_channels * config.patch_size**2, 3, **kw)
        if config.timestep_conditioning:
            self.last_time_embedder = TimeEmbedder(chans[-1] * 2, **kw)
            self.last_scale_shift_table = nn.Parameter(torch.empty(2, chans[-1], **kw), requires_grad=False)


def init_video_decoder(
    generator: torch.Generator, config: DecoderConfig = DecoderConfig(), device=None, dtype=torch.float32
) -> VideoDecoder:
    """Build the decoder and draw its weights on ``device`` (the JAX
    ``init_video_decoder`` init: uniform convs and linears, zero biases and
    tables, mean 0 and std 1 statistics)."""
    if device is None:
        device = generator.device
    decoder = VideoDecoder(config, device=device, dtype=dtype)
    with torch.no_grad():
        for module in decoder.modules():
            if isinstance(module, Conv3d):
                init_conv_(module, generator)
            elif isinstance(module, Linear):
                init_linear_(module, generator)
            elif isinstance(module, DecoderResBlock) and hasattr(module, "scale_shift_table"):
                module.scale_shift_table.zero_()
        if config.timestep_conditioning:
            decoder.last_scale_shift_table.zero_()
    return decoder


def _res_block(block: DecoderResBlock, x: torch.Tensor, causal: bool, padding_mode: str,
               timestep_embed: Optional[torch.Tensor]) -> torch.Tensor:
    """pixel_norm(1e-8) -> timestep modulation -> SiLU -> conv, twice, + x."""
    if timestep_embed is not None:
        b, c = x.shape[0], x.shape[1]
        ada = block.scale_shift_table[None] + timestep_embed.reshape(b, 4, c)
        shift1, scale1, shift2, scale2 = (ada[:, i, :, None, None, None] for i in range(4))
    h = pixel_norm(x, eps=1e-8)
    if timestep_embed is not None:
        h = h * (1 + scale1) + shift1
    h = causal_conv3d(block.conv1, F.silu(h), 3, 1, causal, padding_mode)
    h = pixel_norm(h, eps=1e-8)
    if timestep_embed is not None:
        h = h * (1 + scale2) + shift2
    h = causal_conv3d(block.conv2, F.silu(h), 3, 1, causal, padding_mode)
    return h + x


def add_decode_noise(
    config: DecoderConfig,
    sample: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The timestep-conditioned decoder's noise mix, noise * s + (1 - s) *
    sample with s = ``decode_noise_scale``, in sample's dtype: ``noise``
    (sample's shape) given or drawn in fp32 from ``generator``; the sample
    unchanged with neither, or without timestep conditioning. Elementwise,
    so mixing whole latents and then tiling them equals mixing each tile
    with its slice of the noise."""
    if not config.timestep_conditioning:
        return sample
    if noise is None and generator is not None:
        noise = torch.randn(sample.shape, generator=generator, device=generator.device, dtype=torch.float32)
    if noise is None:
        return sample
    noise = noise.to(device=sample.device, dtype=sample.dtype)
    return noise * config.decode_noise_scale + (1.0 - config.decode_noise_scale) * sample


def video_decoder_apply(
    decoder: VideoDecoder,
    config: DecoderConfig,
    sample: torch.Tensor,
    causal: bool = False,
    timestep: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Decode (B, latent_C, F', H', W') latents to (B, 3, F, H, W) RGB.

    With timestep conditioning, decode noise is mixed in when ``noise`` (same
    shape as ``sample``) is given or ``generator`` draws it; with neither the
    decode is noise-free. ``timestep`` (B,) defaults to decode_timestep.
    """
    b = sample.shape[0]
    dtype = sample.dtype
    x = add_decode_noise(config, sample, noise, generator)
    x = ops.denormalize_latents(x, decoder.latents_mean, decoder.latents_std)

    scaled_timestep = None
    if config.timestep_conditioning:
        if timestep is None:
            timestep = torch.full((b,), config.decode_timestep, dtype=torch.float32, device=x.device)
        scaled_timestep = timestep.float() * 1000.0

    pm = config.padding_mode
    x = causal_conv3d(decoder.conv_in, x, 3, 1, causal, pm)
    chans = config.channel_schedule
    for g in range(len(chans)):
        group = decoder.up_blocks[str(2 * g)]
        ts_embed = None
        if scaled_timestep is not None:
            ts_embed = time_embedder_apply(group.time_embedder, scaled_timestep, dtype)
        for block in group.res_blocks:
            x = _res_block(block, x, causal, pm, ts_embed)
        if g < config.num_upsamples:
            x = depth_to_space_upsample(
                decoder.up_blocks[str(2 * g + 1)], x, (2, 2, 2),
                residual=True, out_channels_reduction_factor=2, causal=causal, padding_mode=pm,
            )

    x = pixel_norm(x, eps=1e-8)
    if scaled_timestep is not None:
        embedded = time_embedder_apply(decoder.last_time_embedder, scaled_timestep, dtype)
        ada = decoder.last_scale_shift_table[None] + embedded.reshape(b, 2, chans[-1])
        x = x * (1 + ada[:, 1, :, None, None, None]) + ada[:, 0, :, None, None, None]
    x = causal_conv3d(decoder.conv_out, F.silu(x), 3, 1, causal, pm)
    return ops.unpatchify(x, patch_size_hw=config.patch_size, patch_size_t=1)
