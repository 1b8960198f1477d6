"""Audio configurators (reference: ltx_core/model/audio_vae/model_configurator.py)."""

from mlx_video_tpu_torch.ltx_core.model.audio_vae import (
    AudioDecoderConfigurator,
    AudioEncoderConfigurator,
    VocoderConfigurator,
)

__all__ = [
    "AudioDecoderConfigurator",
    "AudioEncoderConfigurator",
    "VocoderConfigurator",
]
