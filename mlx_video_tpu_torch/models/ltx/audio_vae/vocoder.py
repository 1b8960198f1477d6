"""HiFi-GAN vocoder: decoded mel spectrograms -> a 24 kHz stereo waveform,
on NCW tensors, and ``decode_audio``, latents -> waveform.

Counterpart of mlx_video_tpu/models/ltx/audio_vae/vocoder.py:
``VocoderConfig``, ``init_vocoder``, ``vocoder_apply`` and ``decode_audio``.
A 7-tap conv, then per level a leaky ReLU (slope 0.1), a transposed conv
(rates 6, 5, 2, 2, 2: 240x in all; padding (k - stride) // 2) and the mean of
three multi-receptive-field residual blocks; then a leaky ReLU of slope 0.01
(PyTorch's default, as the reference), a 7-tap conv and tanh. Weights use
PyTorch's layouts: Conv1d (O, I, K) and ConvTranspose1d (I, O, K); the JAX
package stores both (K, I, O) and io/jax_bridge.py converts. The convolutions
are ``F.conv1d`` and ``F.conv_transpose1d`` (cuDNN on the card).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import AudioDecoder, AudioVAEConfig, audio_decoder_apply
from mlx_video_tpu_torch.ops.linear import uniform_

LRELU_SLOPE = 0.1


class VocoderConfig(NamedTuple):
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    upsample_rates: Tuple[int, ...] = (6, 5, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 15, 8, 4, 4)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_initial_channel: int = 1024
    stereo: bool = True
    resblock: str = "1"
    output_sample_rate: int = 24000
    # channels * mel bins of the decoded spectrogram; None: 2 x 64 stereo
    mel_in_channels: Optional[int] = None

    @property
    def in_channels(self) -> int:
        if self.mel_in_channels is not None:
            return self.mel_in_channels
        return 128 if self.stereo else 64

    @property
    def out_channels(self) -> int:
        return 2 if self.stereo else 1

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.upsample_rates)


class Conv1d(nn.Module):
    """Parameter holder: weight (O, I, K), bias (O,)."""

    def __init__(self, cin: int, cout: int, k: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(cout, cin, k, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(cout, **kw), requires_grad=False)


class ConvTranspose1d(nn.Module):
    """Parameter holder: weight (I, O, K), bias (O,)."""

    def __init__(self, cin: int, cout: int, k: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(cin, cout, k, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(cout, **kw), requires_grad=False)


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel: int, dilations, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.convs1 = nn.ModuleList(Conv1d(channels, channels, kernel, **kw) for _ in dilations)
        self.convs2 = nn.ModuleList(Conv1d(channels, channels, kernel, **kw) for _ in dilations)


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel: int, dilations, device=None, dtype=None):
        super().__init__()
        self.convs = nn.ModuleList(Conv1d(channels, channels, kernel, device=device, dtype=dtype)
                                   for _ in dilations)


class Vocoder(nn.Module):
    """Parameters under the JAX ``init_vocoder`` names (``conv_pre``,
    ``ups.{i}``, ``resblocks.{j}.convs1.{d}``, ``conv_post``)."""

    def __init__(self, config: VocoderConfig = VocoderConfig(), device=None, dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c0 = config.upsample_initial_channel
        self.conv_pre = Conv1d(config.in_channels, c0, 7, **kw)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        block = ResBlock1 if config.resblock == "1" else ResBlock2
        for i, k in enumerate(config.upsample_kernel_sizes):
            cout = c0 // 2 ** (i + 1)
            self.ups.append(ConvTranspose1d(c0 // 2**i, cout, k, **kw))
            for kernel, dils in zip(config.resblock_kernel_sizes, config.resblock_dilation_sizes):
                self.resblocks.append(block(cout, kernel, dils, **kw))
        self.conv_post = Conv1d(c0 // 2 ** len(config.upsample_rates), config.out_channels, 7, **kw)


@torch.no_grad()
def init_vocoder(generator: torch.Generator, config: VocoderConfig = VocoderConfig(), device=None,
                 dtype=torch.bfloat16) -> Vocoder:
    """Build the vocoder and draw its weights on ``device`` from ``generator``:
    U(-1/sqrt(I*K), 1/sqrt(I*K)) with I the input channels (as the JAX
    init), zero bias."""
    if device is None:
        device = generator.device
    vocoder = Vocoder(config, device=device, dtype=dtype)
    for module in vocoder.modules():
        if isinstance(module, (Conv1d, ConvTranspose1d)):
            w = module.weight
            cin = w.shape[0] if isinstance(module, ConvTranspose1d) else w.shape[1]
            uniform_(w, (cin * w.shape[2]) ** -0.5, generator)
            module.bias.zero_()
    return vocoder


def _conv1d(conv: Conv1d, x: torch.Tensor, padding: int = 0, dilation: int = 1) -> torch.Tensor:
    return F.conv1d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=padding, dilation=dilation)


def _resblock(block: nn.Module, x: torch.Tensor, kernel: int, dilations) -> torch.Tensor:
    """Per dilation: leaky ReLU -> dilated conv [-> leaky ReLU -> conv], residual."""
    for i, d in enumerate(dilations):
        xt = F.leaky_relu(x, LRELU_SLOPE)
        if isinstance(block, ResBlock1):
            xt = _conv1d(block.convs1[i], xt, padding=(kernel - 1) * d // 2, dilation=d)
            xt = _conv1d(block.convs2[i], F.leaky_relu(xt, LRELU_SLOPE), padding=(kernel - 1) // 2)
        else:
            xt = _conv1d(block.convs[i], xt, padding=(kernel - 1) * d // 2, dilation=d)
        x = xt + x
    return x


def vocoder_apply(vocoder: Vocoder, config: VocoderConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, M) decoded spectrogram -> (B, out_channels, T * 240)
    waveform in x's dtype."""
    b, c, t, m = x.shape
    x = x.permute(0, 1, 3, 2).reshape(b, c * m, t)
    x = _conv1d(vocoder.conv_pre, x, padding=3)
    n = len(config.resblock_kernel_sizes)
    for i, (stride, k) in enumerate(zip(config.upsample_rates, config.upsample_kernel_sizes)):
        up = vocoder.ups[i]
        x = F.conv_transpose1d(F.leaky_relu(x, LRELU_SLOPE), up.weight.to(x.dtype), up.bias.to(x.dtype),
                               stride=stride, padding=(k - stride) // 2)
        acc = None
        for j in range(n):
            out = _resblock(vocoder.resblocks[i * n + j], x, config.resblock_kernel_sizes[j],
                            config.resblock_dilation_sizes[j])
            acc = out if acc is None else acc + out
        x = acc / n
    x = _conv1d(vocoder.conv_post, F.leaky_relu(x, 0.01), padding=3)
    return torch.tanh(x)


def decode_audio(
    latent: torch.Tensor,
    decoder: AudioDecoder,
    decoder_config: AudioVAEConfig,
    vocoder: Vocoder,
    vocoder_config: VocoderConfig,
) -> torch.Tensor:
    """Latents (B, 8, T, 16) -> spectrogram -> fp32 waveform (B, 2, 240 * (4T
    - 3)), the batch axis dropped at B = 1. Runs in the latents' dtype."""
    wav = vocoder_apply(vocoder, vocoder_config, audio_decoder_apply(decoder, decoder_config, latent))
    if wav.shape[0] == 1:
        wav = wav[0]
    return wav.float()
