"""Audio VAE + vocoder re-exports (reference: ltx_core/model/audio_vae/__init__.py).

``AudioEncoder``, ``AudioDecoder`` and ``Vocoder`` are the reference's class
surface over the engine modules (mlx_video_tpu_torch/models/ltx/audio_vae/),
binding one in place or drawing a fresh one on ``device`` (the card when
None) from ``generator``, which must lie there (seed 0 there when not given).
"""

import torch

from mlx_video_tpu_torch.ltx_core.utils import device_or_card
from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import (
    AudioVAEConfig,
    audio_decoder_apply,
    audio_encoder_apply,
    init_audio_decoder,
    init_audio_encoder,
)
from mlx_video_tpu_torch.models.ltx.audio_vae.processing import AudioProcessor
from mlx_video_tpu_torch.models.ltx.audio_vae.vocoder import (
    VocoderConfig,
    decode_audio,
    init_vocoder,
    vocoder_apply,
)

# Minimal compat constants (reference: audio_vae/__init__.py:5-8).
AUDIO_VAE_ENCODER_COMFY_KEYS_FILTER: dict = {}
AUDIO_VAE_DECODER_COMFY_KEYS_FILTER: dict = {}
VOCODER_COMFY_KEYS_FILTER: dict = {}


class AudioEncoderConfigurator:
    def __init__(self, *_, **__):
        pass


class AudioDecoderConfigurator:
    def __init__(self, *_, **__):
        pass


class VocoderConfigurator:
    def __init__(self, *_, **__):
        pass


class _AudioModule:
    """Base for the class-style adapters over the audio stack."""

    _init = None
    _apply = None
    _config = AudioVAEConfig

    def __init__(self, config=None, params=None, *, generator=None, dtype=None, device=None):
        self.config = config or type(self)._config()
        if params is None:
            device = device_or_card(device)
            generator = generator if generator is not None else torch.Generator(device).manual_seed(0)
            params = type(self)._init(generator, self.config, device=device, dtype=dtype or torch.float32)
        self.params = params

    def __call__(self, x):
        return type(self)._apply(self.params, self.config, x)


class AudioEncoder(_AudioModule):
    """Mel spectrogram -> normalized latents."""

    _init = staticmethod(init_audio_encoder)
    _apply = staticmethod(audio_encoder_apply)


class AudioDecoder(_AudioModule):
    """Latents -> mel spectrogram."""

    _init = staticmethod(init_audio_decoder)
    _apply = staticmethod(audio_decoder_apply)


class Vocoder(_AudioModule):
    """HiFi-GAN spectrogram -> waveform."""

    _init = staticmethod(init_vocoder)
    _apply = staticmethod(vocoder_apply)
    _config = VocoderConfig


__all__ = [
    "AUDIO_VAE_DECODER_COMFY_KEYS_FILTER",
    "AUDIO_VAE_ENCODER_COMFY_KEYS_FILTER",
    "AudioDecoder",
    "AudioDecoderConfigurator",
    "AudioEncoder",
    "AudioEncoderConfigurator",
    "Vocoder",
    "AudioProcessor",
    "AudioVAEConfig",
    "VOCODER_COMFY_KEYS_FILTER",
    "VocoderConfig",
    "VocoderConfigurator",
    "audio_decoder_apply",
    "audio_encoder_apply",
    "decode_audio",
    "init_audio_decoder",
    "init_audio_encoder",
    "init_vocoder",
    "vocoder_apply",
]
