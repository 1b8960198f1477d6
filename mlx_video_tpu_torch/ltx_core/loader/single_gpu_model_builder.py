"""SingleGPUModelBuilder submodule (reference:
ltx_core/loader/single_gpu_model_builder.py). The class lives in
``mlx_video_tpu_torch.ltx_core.loader``; this module re-exports it."""

from mlx_video_tpu_torch.ltx_core.loader import SingleGPUModelBuilder

__all__ = ["SingleGPUModelBuilder"]
