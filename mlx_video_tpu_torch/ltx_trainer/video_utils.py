"""Shim onto the port's trainer (reference: ltx_trainer/video_utils.py)."""

from mlx_video_tpu_torch.trainer.aux import read_video, save_video  # noqa: F401
