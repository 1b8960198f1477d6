"""Shim onto the port's trainer (reference: ltx_trainer/quantization.py)."""

from mlx_video_tpu_torch.trainer.aux import read_quantization_metadata  # noqa: F401
