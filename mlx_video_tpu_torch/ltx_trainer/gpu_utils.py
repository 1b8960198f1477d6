"""Shim onto the port's trainer (reference: ltx_trainer/gpu_utils.py)."""

from mlx_video_tpu_torch.trainer.aux import log_device_memory, set_seed  # noqa: F401
