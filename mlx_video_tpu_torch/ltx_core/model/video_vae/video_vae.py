"""Combined VAE re-export (reference: ltx_core/model/video_vae/video_vae.py)."""

from mlx_video_tpu_torch.models.ltx.video_vae.decoder import (
    init_video_decoder,
    video_decoder_apply,
)
from mlx_video_tpu_torch.models.ltx.video_vae.encoder import (
    init_video_encoder,
    video_encoder_apply,
)

from mlx_video_tpu_torch.ltx_core.model.video_vae import VideoDecoder, VideoEncoder

__all__ = [
    "VideoDecoder",
    "VideoEncoder",
    "init_video_decoder",
    "init_video_encoder",
    "video_decoder_apply",
    "video_encoder_apply",
]
