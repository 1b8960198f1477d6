"""Upsampler configurator (reference: ltx_core/model/upsampler/model_configurator.py)."""

from mlx_video_tpu_torch.ltx_core.model.upsampler import LatentUpsamplerConfigurator

__all__ = ["LatentUpsamplerConfigurator"]
