"""Shim onto the port's trainer (reference: ltx_trainer/hf_hub_utils.py)."""

from mlx_video_tpu_torch.trainer.aux import push_to_hub  # noqa: F401
