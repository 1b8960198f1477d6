"""Latent tools: patchify/unpatchify/conditioning helpers over LatentState.

Counterpart of ltx_core/tools.py (reference ltx_core/tools.py:
VideoLatentTools / AudioLatentTools over the Patchifier protocol). The
initial state is drawn from an explicit ``torch.Generator`` (fp32, cast to
``dtype``), or taken from ``initial_latent``, or zeros, and lies on
``device`` (the card when None).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Union

import torch

from mlx_video_tpu_torch.ltx_core.components.patchifiers import (
    AudioPatchifier,
    VideoLatentPatchifier,
    get_pixel_coords,
)
from mlx_video_tpu_torch.ltx_core.components.protocols import Patchifier  # noqa: F401 (parity export)
from mlx_video_tpu_torch.ltx_core.types import (
    AudioLatentShape,
    LatentState,
    SpatioTemporalScaleFactors,
    VideoLatentShape,
)
from mlx_video_tpu_torch.ltx_core.utils import device_or_card

DEFAULT_SCALE_FACTORS = SpatioTemporalScaleFactors.default()


def _initial_latent(shape, generator: Optional[torch.Generator], dtype, initial_latent, device) -> torch.Tensor:
    device = device_or_card(device)
    if initial_latent is not None:
        return initial_latent.to(device=device, dtype=dtype)
    if generator is not None:
        draw = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
        return draw.to(device=device, dtype=dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


class _LatentToolsBase:
    patchifier: object
    target_shape: Union[VideoLatentShape, AudioLatentShape]

    def patchify(self, latent_state: LatentState) -> LatentState:
        if tuple(latent_state.latent.shape) != self.target_shape.to_shape():
            raise ValueError(
                f"Latent state has shape {tuple(latent_state.latent.shape)}, expected "
                f"{self.target_shape.to_shape()}"
            )
        state = latent_state.clone()
        return replace(
            state,
            latent=self.patchifier.patchify(state.latent),
            clean_latent=self.patchifier.patchify(state.clean_latent),
            denoise_mask=self.patchifier.patchify(state.denoise_mask),
        )

    def unpatchify(self, latent_state: LatentState) -> LatentState:
        state = latent_state.clone()
        return replace(
            state,
            latent=self.patchifier.unpatchify(state.latent, output_shape=self.target_shape),
            clean_latent=self.patchifier.unpatchify(state.clean_latent, output_shape=self.target_shape),
            denoise_mask=self.patchifier.unpatchify(
                state.denoise_mask, output_shape=self.target_shape.mask_shape()
            ),
        )

    def clear_conditioning(self, latent_state: LatentState) -> LatentState:
        state = latent_state.clone()
        n = self.patchifier.get_token_count(self.target_shape)
        return LatentState(
            latent=state.latent[:, :n],
            clean_latent=state.clean_latent[:, :n],
            denoise_mask=torch.ones_like(state.denoise_mask)[:, :n],
            positions=state.positions[:, :, :n] if state.positions is not None else None,
        )


# Reference protocol name for the shared tools interface
# (reference: ltx_core/tools.py:21-30).
LatentTools = _LatentToolsBase


@dataclass
class VideoLatentTools(_LatentToolsBase):
    target_shape: VideoLatentShape
    scale_factors: SpatioTemporalScaleFactors = DEFAULT_SCALE_FACTORS
    patch_size: int = 1
    fps: float = 24.0
    causal_fix: bool = True  # (reference: tools.py:66; keyframe apply_to reads it)

    def __post_init__(self):
        self.patchifier = VideoLatentPatchifier(self.patch_size)

    def create_initial_state(
        self,
        generator: Optional[torch.Generator] = None,
        dtype=torch.float32,
        initial_latent: Optional[torch.Tensor] = None,
        device=None,
    ) -> LatentState:
        shape = self.target_shape.to_shape()
        latent = _initial_latent(shape, generator, dtype, initial_latent, device)
        coords = self.patchifier.get_patch_grid_bounds(self.target_shape, device=latent.device)
        positions = get_pixel_coords(coords, self.scale_factors, causal_fix=True)
        positions[:, 0] /= self.fps
        return LatentState(
            latent=latent,
            clean_latent=torch.zeros(shape, dtype=dtype, device=latent.device),
            denoise_mask=torch.ones(self.target_shape.mask_shape().to_shape(), dtype=dtype, device=latent.device),
            positions=positions,
        )


@dataclass
class AudioLatentTools(_LatentToolsBase):
    target_shape: AudioLatentShape
    patch_size: int = 1

    def __post_init__(self):
        self.patchifier = AudioPatchifier(self.patch_size)

    def create_initial_state(
        self,
        generator: Optional[torch.Generator] = None,
        dtype=torch.float32,
        initial_latent: Optional[torch.Tensor] = None,
        device=None,
    ) -> LatentState:
        shape = self.target_shape.to_shape()
        latent = _initial_latent(shape, generator, dtype, initial_latent, device)
        positions = self.patchifier.get_patch_grid_bounds(self.target_shape, device=latent.device)
        return LatentState(
            latent=latent,
            clean_latent=torch.zeros(shape, dtype=dtype, device=latent.device),
            denoise_mask=torch.ones(self.target_shape.mask_shape().to_shape(), dtype=dtype, device=latent.device),
            positions=positions,
        )
