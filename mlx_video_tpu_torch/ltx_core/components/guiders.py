"""Guidance combiners: CFG, CFG*, STG, APG, on tensors.

Counterpart of ltx_core/components/guiders.py (reference
ltx_core/components/guiders.py:23-108). Every delta is a pure tensor
function; LegacyStatefulAPGGuider keeps its momentum's running average on
the object, as it does in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


def _l2_norm(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + 1e-8)


def projection_coef(to_project: torch.Tensor, project_onto: torch.Tensor) -> torch.Tensor:
    b = to_project.shape[0]
    p = to_project.reshape(b, -1)
    q = project_onto.reshape(b, -1)
    dot = torch.sum(p * q, dim=1, keepdim=True)
    sq = torch.sum(q * q, dim=1, keepdim=True) + 1e-8
    return dot / sq


def _per_row(coef: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return coef.reshape((-1,) + (1,) * (like.dim() - 1))


@dataclass(frozen=True)
class CFGGuider:
    scale: float

    def delta(self, cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
        return (self.scale - 1) * (cond - uncond)

    def enabled(self) -> bool:
        return self.scale != 1.0


@dataclass(frozen=True)
class CFGStarRescalingGuider:
    scale: float

    def delta(self, cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
        rescaled_neg = _per_row(projection_coef(cond, uncond), uncond) * uncond
        return (self.scale - 1) * (cond - rescaled_neg)

    def enabled(self) -> bool:
        return self.scale != 1.0


@dataclass(frozen=True)
class STGGuider:
    scale: float

    def delta(self, pos_denoised: torch.Tensor, perturbed_denoised: torch.Tensor) -> torch.Tensor:
        return self.scale * (pos_denoised - perturbed_denoised)

    def enabled(self) -> bool:
        return self.scale != 0.0


def _apg_delta(guidance, cond, eta, norm_threshold, scale_mult):
    if norm_threshold > 0:
        gn = _l2_norm(guidance, dim=(-1, -2, -3), keepdim=True)
        guidance = guidance * torch.clamp(norm_threshold / gn, max=1.0)
    g_parallel = _per_row(projection_coef(guidance, cond), cond) * cond
    g_orth = guidance - g_parallel
    return (g_parallel * eta + g_orth) * scale_mult


@dataclass(frozen=True)
class LtxAPGGuider:
    scale: float
    eta: float = 1.0
    norm_threshold: float = 0.0

    def delta(self, cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
        return _apg_delta(cond - uncond, cond, self.eta, self.norm_threshold, self.scale - 1)

    def enabled(self) -> bool:
        return self.scale != 1.0


@dataclass
class LegacyStatefulAPGGuider:
    scale: float
    eta: float
    norm_threshold: float = 5.0
    momentum: float = 0.0
    running_avg: Optional[torch.Tensor] = None

    def delta(self, cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
        guidance = cond - uncond
        if self.momentum != 0:
            if self.running_avg is None:
                self.running_avg = guidance
            else:
                self.running_avg = self.momentum * self.running_avg + guidance
            guidance = self.running_avg
        return _apg_delta(guidance, cond, self.eta, self.norm_threshold, self.scale)

    def enabled(self) -> bool:
        return self.scale != 0.0
