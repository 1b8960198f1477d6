"""Trainer package (the reference's names): re-exports onto the port's trainer
(reference: ltx_trainer/* one-line shims onto mlx_video.mlx_trainer)."""

from mlx_video_tpu_torch.trainer.config import TrainingConfig, load_training_config
from mlx_video_tpu_torch.trainer.datasets import (
    Batch,
    DummyDataset,
    PrecomputedDataset,
    collate_batches,
    iter_batches,
)
from mlx_video_tpu_torch.trainer.trainer import Trainer
