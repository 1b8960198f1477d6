"""Shim onto the port's trainer (reference: ltx_trainer/utils.py)."""

from mlx_video_tpu_torch.trainer.aux import set_seed  # noqa: F401
