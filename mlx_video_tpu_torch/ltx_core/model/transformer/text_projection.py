"""Caption-projection re-export (reference:
ltx_core/model/transformer/text_projection.py); the module class
``TextProjection`` stands for the JAX ``init_text_projection``."""

from mlx_video_tpu_torch.models.ltx.model import TextProjection, text_projection_apply

__all__ = ["TextProjection", "text_projection_apply"]
