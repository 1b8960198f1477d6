"""Pipeline utilities (reference: ltx_pipelines/utils/__init__.py)."""

from mlx_video_tpu_torch.ltx_pipelines.utils.model_ledger import ModelLedger

__all__ = ["ModelLedger"]
