"""Shim onto the port's trainer (reference: ltx_trainer/trainer.py)."""

from mlx_video_tpu_torch.trainer.config import TrainingConfig, load_training_config  # noqa: F401
from mlx_video_tpu_torch.trainer.trainer import Trainer, build_model_config  # noqa: F401

# Reference class name (mlx_video/mlx_trainer/trainer.py:93 MLXTrainer).
MLXTrainer = Trainer

__all__ = [
    "MLXTrainer",
    "Trainer",
    "TrainingConfig",
    "build_model_config",
    "load_training_config",
]
