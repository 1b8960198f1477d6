"""VAE configurators and config enums (reference:
ltx_core/model/video_vae/model_configurator.py)."""

from mlx_video_tpu_torch.ltx_core.model.video_vae import VideoDecoderConfigurator, VideoEncoderConfigurator
from mlx_video_tpu_torch.ltx_core.model.video_vae.enums import (
    LogVarianceType,
    NormLayerType,
    PaddingModeType,
)

__all__ = [
    "LogVarianceType",
    "NormLayerType",
    "PaddingModeType",
    "VideoDecoderConfigurator",
    "VideoEncoderConfigurator",
]
