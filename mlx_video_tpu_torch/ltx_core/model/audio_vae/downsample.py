"""Downsample re-export (reference: ltx_core/model/audio_vae/downsample.py);
the module class ``Downsample`` stands for the JAX ``init_downsample``."""

from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import Downsample, downsample

build_downsampling_path = downsample  # reference-name alias

__all__ = ["Downsample", "build_downsampling_path", "downsample"]
