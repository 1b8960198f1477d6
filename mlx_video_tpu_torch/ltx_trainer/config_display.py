"""Shim onto the port's trainer (reference: ltx_trainer/config_display.py)."""

from mlx_video_tpu_torch.trainer.aux import print_config  # noqa: F401
