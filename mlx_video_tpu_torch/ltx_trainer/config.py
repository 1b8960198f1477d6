"""Shim onto the port's trainer (reference: ltx_trainer/config.py)."""

from mlx_video_tpu_torch.trainer.config import TrainingConfig, load_training_config  # noqa: F401
