"""Transformer re-exports (reference: ltx_core/model/transformer/__init__.py).

The engine's DiT is an ``nn.Module`` holding the parameters
(mlx_video_tpu_torch/models/ltx/model.py:LTXModel) run by the plain
function ``ltx_apply``; these names map the reference's class surface onto
it. ``LTXModel(config, model)`` wraps an engine module in place (no second
copy of the weights); ``X0Model`` turns its velocities into denoised
estimates.

The reference's denoising helpers call ``transformer(..., perturbations=...)``
(ltx_pipelines/utils/helpers.py). Neither DiT implements perturbed
attention, so a ``perturbations`` that is None or perturbs no block runs the
plain forward, and one that perturbs a block (STG) is refused by name.
"""

from mlx_video_tpu_torch.config import LTXModelConfig, LTXRopeType, TransformerConfig
from mlx_video_tpu_torch.ltx_core.utils import device_or_card
from mlx_video_tpu_torch.models.ltx import rope
from mlx_video_tpu_torch.models.ltx.model import (
    Modality,
    attention_apply,
    block_apply,
    feed_forward_apply,
    init_ltx_params,
    ltx_apply,
    text_projection_apply,
    to_denoised,
)

# Compatibility constants for the legacy loader API
# (reference: ltx_core/model/transformer/__init__.py:7-10).
LTXV_MODEL_COMFY_RENAMING_MAP: dict = {}
LTXV_MODEL_COMFY_RENAMING_WITH_TRANSFORMER_LINEAR_DOWNCAST_MAP: dict = {}
UPCAST_DURING_INFERENCE: set = set()


class LTXModelConfigurator:
    """Builds an ``LTXModelConfig`` (reference: transformer/__init__.py:13-18)."""

    def __init__(self, *_, **__):
        pass

    def build(self) -> LTXModelConfig:
        return LTXModelConfig()


class LTXVideoOnlyModelConfigurator(LTXModelConfigurator):
    pass


class UpcastWithStochasticRounding:
    """Compatibility marker (reference: transformer/__init__.py:25-26)."""


def _perturbs_a_block(perturbations) -> bool:
    """Whether a PerturbationConfig or BatchedPerturbationConfig holds a
    Perturbation of any block (``blocks`` None, all of them, or non-empty)."""
    items = getattr(perturbations, "perturbations", None) or []
    if items and hasattr(items[0], "perturbations"):  # batched: one config a row
        items = [p for config in items for p in config.perturbations or []]
    return any(p.blocks is None or len(p.blocks) > 0 for p in items)


def _refuse_perturbations(perturbations) -> None:
    if _perturbs_a_block(perturbations):
        raise NotImplementedError(
            "STG (spatio-temporal guidance): perturbations that skip attention in a block are not "
            "supported; neither DiT implements perturbed attention. Pass perturbations=None or an "
            "empty PerturbationConfig."
        )


class LTXModel:
    """Class-style adapter over the engine DiT (reference: an ``LTXModel``
    nn.Module). ``LTXModel(config, model)`` binds an engine
    ``models/ltx/model.py:LTXModel`` in place; ``LTXModel(config)`` draws a
    fresh one on ``device`` (the card when None) from ``generator``, which
    must lie there (seed 0 there when not given).
    Calling returns the per-modality velocities."""

    def __init__(self, config: LTXModelConfig = None, params=None, *, generator=None, dtype=None, device=None):
        import torch

        self.config = config or LTXModelConfig()
        if params is None:
            device = device_or_card(device)
            generator = generator if generator is not None else torch.Generator(device).manual_seed(0)
            params = init_ltx_params(self.config, generator, device=device, dtype=dtype or torch.bfloat16)
        self.params = params

    def __call__(self, video=None, audio=None, perturbations=None, **kw):
        _refuse_perturbations(perturbations)
        return ltx_apply(self.params, self.config, video=video, audio=audio, **kw)


class X0Model:
    """Velocity -> denoised wrapper (reference: ltx.py X0Model;
    x0 = x_t - sigma * v)."""

    def __init__(self, model: LTXModel):
        self.model = model

    def __call__(self, video=None, audio=None, perturbations=None, **kw):
        v_vel, a_vel = self.model(video=video, audio=audio, perturbations=perturbations, **kw)
        v_x0 = (
            to_denoised(video.latent, v_vel, video.timesteps[..., None])
            if video is not None and v_vel is not None
            else v_vel
        )
        a_x0 = (
            to_denoised(audio.latent, a_vel, audio.timesteps[..., None])
            if audio is not None and a_vel is not None
            else a_vel
        )
        return v_x0, a_x0


__all__ = [
    "LTXV_MODEL_COMFY_RENAMING_MAP",
    "LTXV_MODEL_COMFY_RENAMING_WITH_TRANSFORMER_LINEAR_DOWNCAST_MAP",
    "UPCAST_DURING_INFERENCE",
    "LTXModelConfig",
    "LTXModelConfigurator",
    "LTXRopeType",
    "LTXVideoOnlyModelConfigurator",
    "LTXModel",
    "Modality",
    "TransformerConfig",
    "UpcastWithStochasticRounding",
    "X0Model",
    "attention_apply",
    "block_apply",
    "feed_forward_apply",
    "init_ltx_params",
    "ltx_apply",
    "rope",
    "text_projection_apply",
    "to_denoised",
]
