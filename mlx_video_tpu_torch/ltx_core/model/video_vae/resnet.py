"""Resnet re-export (reference: ltx_core/model/video_vae/resnet.py); the
module class ``ResnetBlock3D`` stands for the JAX ``init_resnet_block``."""

from mlx_video_tpu_torch.models.ltx.video_vae.blocks import (
    ResnetBlock3D,
    pixel_norm,
    resnet_block,
)

__all__ = ["ResnetBlock3D", "pixel_norm", "resnet_block"]
