"""Up/down-sampling re-export (reference: ltx_core/model/video_vae/sampling.py);
the module classes stand for the JAX ``init_*`` functions."""

from mlx_video_tpu_torch.models.ltx.video_vae.blocks import (
    DepthToSpaceUpsample,
    SpaceToDepthDownsample,
    depth_to_space_upsample,
    space_to_depth_downsample,
)

__all__ = [
    "DepthToSpaceUpsample",
    "SpaceToDepthDownsample",
    "depth_to_space_upsample",
    "space_to_depth_downsample",
]
