"""Encoder re-export (reference: ltx_core/model/video_vae/encoder.py)."""

from mlx_video_tpu_torch.models.ltx.video_vae.encoder import (
    encode_image,
    init_video_encoder,
    video_encoder_apply,
)

__all__ = ["encode_image", "init_video_encoder", "video_encoder_apply"]
