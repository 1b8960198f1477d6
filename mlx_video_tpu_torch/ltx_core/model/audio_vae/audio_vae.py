"""Audio VAE re-export (reference: ltx_core/model/audio_vae/audio_vae.py)."""

from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import (
    AudioVAEConfig,
    audio_decoder_apply,
    audio_encoder_apply,
    init_audio_decoder,
    init_audio_encoder,
    patchify_audio,
    unpatchify_audio,
)

__all__ = [
    "AudioVAEConfig",
    "audio_decoder_apply",
    "audio_encoder_apply",
    "init_audio_decoder",
    "init_audio_encoder",
    "patchify_audio",
    "unpatchify_audio",
]
