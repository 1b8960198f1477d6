"""Component protocols (reference: ltx_core/components/protocols.py)."""

from __future__ import annotations

from typing import Protocol

import torch


class Patchifier(Protocol):
    def patchify(self, latents: torch.Tensor) -> torch.Tensor: ...

    def unpatchify(self, latents: torch.Tensor, output_shape) -> torch.Tensor: ...

    def get_patch_grid_bounds(self, output_shape, device=None) -> torch.Tensor: ...

    def get_token_count(self, tgt_shape) -> int: ...


class Noiser(Protocol):
    def noise(self, latents: torch.Tensor) -> torch.Tensor: ...


class GuiderProtocol(Protocol):
    def delta(self, cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor: ...

    def enabled(self) -> bool: ...


class SchedulerProtocol(Protocol):
    def execute(self, steps: int, **kwargs): ...


class DiffusionStepProtocol(Protocol):
    def execute(
        self, sample: torch.Tensor, denoised_sample: torch.Tensor, sigmas, step_index: int
    ) -> torch.Tensor: ...
