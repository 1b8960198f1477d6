"""Model re-exports (reference: ltx_core/model/* re-export shims onto the
engine package)."""

from mlx_video_tpu_torch.config import (
    LTXModelConfig,
    LTXModelType,
    LTXRopeType,
    TransformerConfig,
    VideoVAEConfig,
)
from mlx_video_tpu_torch.models.ltx.model import Modality, init_ltx_params, ltx_apply

from mlx_video_tpu_torch.ltx_core.model.model_protocol import ModelConfigurator, ModelType

__all__ = [
    "LTXModelConfig",
    "LTXModelType",
    "LTXRopeType",
    "TransformerConfig",
    "VideoVAEConfig",
    "Modality",
    "init_ltx_params",
    "ltx_apply",
    "ModelConfigurator",
    "ModelType",
]
