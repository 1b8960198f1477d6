"""Upsampler res-block re-export (reference: ltx_core/model/upsampler/res_block.py);
the module class ``ResBlock3D`` stands for the JAX ``init_res_block_3d``."""

from mlx_video_tpu_torch.models.ltx.upsampler import ResBlock3D, res_block_3d

__all__ = ["ResBlock3D", "res_block_3d"]
