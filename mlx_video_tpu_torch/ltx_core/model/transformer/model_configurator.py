"""Configurator compat (reference: ltx_core/model/transformer/model_configurator.py)."""

from mlx_video_tpu_torch.ltx_core.model.transformer import (
    LTXV_MODEL_COMFY_RENAMING_MAP,
    LTXV_MODEL_COMFY_RENAMING_WITH_TRANSFORMER_LINEAR_DOWNCAST_MAP,
    UPCAST_DURING_INFERENCE,
    LTXModelConfigurator,
    LTXVideoOnlyModelConfigurator,
    UpcastWithStochasticRounding,
)

__all__ = [
    "LTXV_MODEL_COMFY_RENAMING_MAP",
    "LTXV_MODEL_COMFY_RENAMING_WITH_TRANSFORMER_LINEAR_DOWNCAST_MAP",
    "UPCAST_DURING_INFERENCE",
    "LTXModelConfigurator",
    "LTXVideoOnlyModelConfigurator",
    "UpcastWithStochasticRounding",
]
