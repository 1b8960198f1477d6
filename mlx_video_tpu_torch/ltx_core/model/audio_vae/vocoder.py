"""Vocoder re-export (reference: ltx_core/model/audio_vae/vocoder.py)."""

from mlx_video_tpu_torch.models.ltx.audio_vae.vocoder import (
    VocoderConfig,
    decode_audio,
    init_vocoder,
    vocoder_apply,
)

__all__ = ["VocoderConfig", "decode_audio", "init_vocoder", "vocoder_apply"]
