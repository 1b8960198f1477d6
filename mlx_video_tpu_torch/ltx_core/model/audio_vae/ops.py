"""Audio ops re-export (reference: ltx_core/model/audio_vae/ops.py); the
module class ``PerChannelStatistics`` stands for the JAX
``init_per_channel_statistics``."""

from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import (
    PerChannelStatistics,
    patchify_audio,
    unpatchify_audio,
)
from mlx_video_tpu_torch.models.ltx.audio_vae.processing import AudioProcessor
from mlx_video_tpu_torch.models.ltx.audio_vae.vocoder import decode_audio

__all__ = [
    "AudioProcessor",
    "PerChannelStatistics",
    "decode_audio",
    "patchify_audio",
    "unpatchify_audio",
]
