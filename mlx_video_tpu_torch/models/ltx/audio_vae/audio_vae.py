"""Audio VAE decoder: latents (B, 8, T, 16) -> stereo mel spectrograms
(B, 2, 4T - 3, 64), on NCHW tensors whose height is time and width mel.

Counterpart of the decoder side of mlx_video_tpu/models/ltx/audio_vae/
audio_vae.py: ``AudioVAEConfig``, ``patchify_audio`` / ``unpatchify_audio``
(here on channels-first tensors), ``init_audio_decoder`` and
``audio_decoder_apply``. The network is a 2-D conv net, causal in time (each
3x3 conv pads k - 1 rows before the time axis and symmetrically on mel),
with pixel norm (an RMS norm over channels, fp32) and SiLU in its residual
blocks and nearest 2x upsampling; the latents are de-normalised per
(channel, mel bin) by the statistics first, and the output is cropped or
padded to 4T - 3 frames of 64 mel bins. Weights use PyTorch's (O, I, kh, kw)
layout; the JAX package stores (kh, kw, I, O) and io/jax_bridge.py permutes
between the two. The convolutions are ``F.conv2d`` (cuDNN on the card).

Not ported yet: the encoder (audio precompute only).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mlx_video_tpu_torch.models.ltx.video_vae.conv import Conv2d, init_conv_


class AudioVAEConfig(NamedTuple):
    """Encoder/decoder geometry; the defaults are the LTX-2 checkpoint's
    (no attention blocks), as in the JAX package."""

    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    in_channels: int = 2
    out_ch: int = 2
    z_channels: int = 8
    double_z: bool = True
    resolution: int = 256
    attn_resolutions: Tuple[int, ...] = ()
    decoder_attn_resolutions: Tuple[int, ...] = ()
    mid_block_add_attention: bool = False
    mel_bins: int = 64
    latent_downsample_factor: int = 4
    sample_rate: int = 16000
    mel_hop_length: int = 160
    is_causal: bool = True


def _pixel_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the channel axis in fp32, back in x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(dim=1, keepdim=True) + eps)).to(x.dtype)


def _conv(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))


def causal_conv2d(conv: Conv2d, x: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """k x k conv padding k - 1 rows before the time axis (or symmetric when
    not causal) and symmetrically on mel."""
    k = conv.weight.shape[-1]
    mel = ((k - 1) // 2, (k - 1) - (k - 1) // 2)
    time = (k - 1, 0) if causal else mel
    return _conv(conv, F.pad(x, (*mel, *time)))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = Conv2d(cin, cout, 3, **kw)
        self.conv2 = Conv2d(cout, cout, 3, **kw)
        if cin != cout:
            self.nin_shortcut = Conv2d(cin, cout, 1, **kw)


def resnet_block(block: ResnetBlock, x: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """pixel norm -> SiLU -> causal conv, twice, plus the shortcut."""
    h = causal_conv2d(block.conv1, F.silu(_pixel_norm(x)), causal)
    h = causal_conv2d(block.conv2, F.silu(_pixel_norm(h)), causal)
    if hasattr(block, "nin_shortcut"):
        x = causal_conv2d(block.nin_shortcut, x, causal)
    return x + h


class AttnBlock(nn.Module):
    def __init__(self, c: int, device=None, dtype=None):
        super().__init__()
        for name in ("q", "k", "v", "proj_out"):
            setattr(self, name, Conv2d(c, c, 1, device=device, dtype=dtype))


def attn_block(block: AttnBlock, x: torch.Tensor) -> torch.Tensor:
    """Single-head self-attention over the (time, mel) positions."""
    h = _pixel_norm(x)
    q, k, v = (_conv(getattr(block, n), h) for n in ("q", "k", "v"))
    b, c, t, m = q.shape
    q, k, v = (y.reshape(b, c, t * m) for y in (q, k, v))
    w = torch.softmax(torch.einsum("bcq,bck->bqk", q, k) * c**-0.5, dim=-1)
    h = torch.einsum("bqk,bck->bcq", w, v).reshape(b, c, t, m)
    return x + _conv(block.proj_out, h)


class Upsample(nn.Module):
    def __init__(self, c: int, device=None, dtype=None):
        super().__init__()
        self.conv = Conv2d(c, c, 3, device=device, dtype=dtype)


def upsample(up: Upsample, x: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Nearest 2x on both axes, causal conv, then the first time row dropped
    (it undoes the causal pad)."""
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    x = causal_conv2d(up.conv, x, causal)
    return x[:, :, 1:] if causal else x


class PerChannelStatistics(nn.Module):
    """fp32 (channels * mel bins,) latent statistics."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        for name in ("std_of_means", "mean_of_means"):
            setattr(self, name, nn.Parameter(torch.empty(channels, device=device, dtype=torch.float32),
                                             requires_grad=False))


class UpStage(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = nn.ModuleDict()
        self.attn = nn.ModuleDict()


class AudioDecoder(nn.Module):
    """Parameters under the JAX ``init_audio_decoder`` names
    (``up.{level}.block.{i}.conv1``, ``mid.block_1``, ...)."""

    def __init__(self, config: AudioVAEConfig = AudioVAEConfig(), device=None, dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n_res = len(config.ch_mult)
        base_ch = config.ch * config.ch_mult[-1]
        self.conv_in = Conv2d(config.z_channels, base_ch, 3, **kw)
        self.per_channel_statistics = PerChannelStatistics(
            config.z_channels * (config.mel_bins // config.latent_downsample_factor), device=device)
        self.mid = nn.ModuleDict({"block_1": ResnetBlock(base_ch, base_ch, **kw),
                                  "block_2": ResnetBlock(base_ch, base_ch, **kw)})
        if config.mid_block_add_attention:
            self.mid["attn_1"] = AttnBlock(base_ch, **kw)
        self.up = nn.ModuleDict()
        block_in = base_ch
        curr_res = config.resolution // (2 ** (n_res - 1))
        for level in reversed(range(n_res)):
            stage = UpStage()
            block_out = config.ch * config.ch_mult[level]
            for i in range(config.num_res_blocks + 1):
                stage.block[str(i)] = ResnetBlock(block_in, block_out, **kw)
                block_in = block_out
                if curr_res in config.decoder_attn_resolutions:
                    stage.attn[str(i)] = AttnBlock(block_in, **kw)
            if level != 0:
                stage.upsample = Upsample(block_in, **kw)
                curr_res *= 2
            self.up[str(level)] = stage
        self.conv_out = Conv2d(block_in, config.out_ch, 3, **kw)


@torch.no_grad()
def init_audio_decoder(generator: torch.Generator, config: AudioVAEConfig = AudioVAEConfig(), device=None,
                       dtype=torch.bfloat16) -> AudioDecoder:
    """Build the decoder and draw its convs on ``device`` from ``generator``
    (U(-1/sqrt(fan_in), 1/sqrt(fan_in)), zero bias; statistics std one, mean
    zero, as the JAX init)."""
    if device is None:
        device = generator.device
    decoder = AudioDecoder(config, device=device, dtype=dtype)
    for module in decoder.modules():
        if isinstance(module, Conv2d):
            init_conv_(module, generator)
    decoder.per_channel_statistics.std_of_means.fill_(1.0)
    decoder.per_channel_statistics.mean_of_means.zero_()
    return decoder


def patchify_audio(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, M) -> (B, T, C*M), channel-major ('b c t f -> b t (c f)')."""
    b, c, t, m = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, c * m)


def unpatchify_audio(x: torch.Tensor, channels: int, mel_bins: int) -> torch.Tensor:
    """(B, T, C*M) -> (B, C, T, M)."""
    b, t, _ = x.shape
    return x.reshape(b, t, channels, mel_bins).permute(0, 2, 1, 3)


def audio_decoder_apply(decoder: AudioDecoder, config: AudioVAEConfig, sample: torch.Tensor) -> torch.Tensor:
    """Decode normalised latents (B, z, T', M') to spectrograms (B, out_ch,
    T, M), T = 4T' - 3 (causal) and M = mel_bins, in the latents' dtype."""
    causal = config.is_causal
    b, z, t_lat, mel_lat = sample.shape
    stats = decoder.per_channel_statistics
    denorm = patchify_audio(sample).float() * stats.std_of_means + stats.mean_of_means
    h = unpatchify_audio(denorm.to(sample.dtype), z, mel_lat)

    target_t = t_lat * config.latent_downsample_factor
    if causal:
        target_t = max(target_t - (config.latent_downsample_factor - 1), 1)
    target_m = config.mel_bins

    h = causal_conv2d(decoder.conv_in, h, causal)
    h = resnet_block(decoder.mid["block_1"], h, causal)
    if "attn_1" in decoder.mid:
        h = attn_block(decoder.mid["attn_1"], h)
    h = resnet_block(decoder.mid["block_2"], h, causal)
    for level in reversed(range(len(config.ch_mult))):
        stage = decoder.up[str(level)]
        for i in range(config.num_res_blocks + 1):
            h = resnet_block(stage.block[str(i)], h, causal)
            if str(i) in stage.attn:
                h = attn_block(stage.attn[str(i)], h)
        if level != 0:
            h = upsample(stage.upsample, h, causal)
    h = causal_conv2d(decoder.conv_out, F.silu(_pixel_norm(h)), causal)

    h = h[:, : config.out_ch, :target_t, :target_m]
    pad_t, pad_m = target_t - h.shape[2], target_m - h.shape[3]
    if pad_t > 0 or pad_m > 0:
        h = F.pad(h, (0, max(pad_m, 0), 0, max(pad_t, 0)))
    return h
