"""Causal conv2d re-export (reference: ltx_core/model/audio_vae/causal_conv_2d.py);
the module class ``Conv2d`` stands for the JAX ``init_conv2d``."""

from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import causal_conv2d
from mlx_video_tpu_torch.models.ltx.video_vae.conv import Conv2d

__all__ = ["Conv2d", "causal_conv2d"]
