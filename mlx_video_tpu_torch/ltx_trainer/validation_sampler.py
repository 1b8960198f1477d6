"""Shim onto the port's trainer (reference: ltx_trainer/validation_sampler.py)."""

from mlx_video_tpu_torch.trainer.validation_sampler import ValidationSampler  # noqa: F401
