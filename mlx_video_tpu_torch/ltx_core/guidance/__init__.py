"""Guidance perturbations (reference: ltx_core/guidance/__init__.py)."""

from mlx_video_tpu_torch.ltx_core.guidance.perturbations import (
    BatchedPerturbationConfig,
    Perturbation,
    PerturbationConfig,
    PerturbationType,
)

__all__ = [
    "BatchedPerturbationConfig",
    "Perturbation",
    "PerturbationConfig",
    "PerturbationType",
]
