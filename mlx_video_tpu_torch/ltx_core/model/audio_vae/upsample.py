"""Upsample re-export (reference: ltx_core/model/audio_vae/upsample.py); the
module class ``Upsample`` stands for the JAX ``init_upsample``."""

from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import Upsample, upsample

build_upsampling_path = upsample  # reference-name alias

__all__ = ["Upsample", "build_upsampling_path", "upsample"]
