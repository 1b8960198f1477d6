"""Causal-conv re-export (reference: ltx_core/model/video_vae/convolution.py);
the module classes ``Conv2d`` and ``Conv3d`` stand for the JAX
``init_conv2d``/``init_conv3d``, whose ``conv2d`` the port runs inline."""

from mlx_video_tpu_torch.models.ltx.video_vae.conv import (
    Conv2d,
    Conv3d,
    causal_conv3d,
    spatial_pad,
    temporal_causal_pad,
)

__all__ = [
    "Conv2d",
    "Conv3d",
    "causal_conv3d",
    "spatial_pad",
    "temporal_causal_pad",
]
