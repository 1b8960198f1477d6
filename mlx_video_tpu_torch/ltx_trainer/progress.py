"""Shim onto the port's trainer (reference: ltx_trainer/progress.py)."""

from mlx_video_tpu_torch.trainer.aux import ProgressStats, TrainingProgress  # noqa: F401
