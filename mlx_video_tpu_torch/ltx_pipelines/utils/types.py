"""Pipeline component containers and protocols
(reference: ltx_pipelines/utils/types.py)."""

from __future__ import annotations

from typing import Protocol, Tuple

import torch

from mlx_video_tpu_torch.ltx_core.components.patchifiers import AudioPatchifier, VideoLatentPatchifier
from mlx_video_tpu_torch.ltx_core.types import LatentState
from mlx_video_tpu_torch.ltx_pipelines.utils.constants import VIDEO_LATENT_CHANNELS, VIDEO_SCALE_FACTORS


class PipelineComponents:
    """Container for shared pipeline components. ``device`` is where the
    composed denoise helpers build their states (the card when None)."""

    def __init__(self, dtype, device=None):
        self.dtype = dtype
        self.device = device
        self.video_scale_factors = VIDEO_SCALE_FACTORS
        self.video_latent_channels = VIDEO_LATENT_CHANNELS
        self.video_patchifier = VideoLatentPatchifier(patch_size=1)
        self.audio_patchifier = AudioPatchifier(patch_size=1)


class DenoisingFunc(Protocol):
    def __call__(
        self, video_state: LatentState, audio_state: LatentState, sigmas, step_index: int
    ) -> Tuple[torch.Tensor, torch.Tensor]: ...


class DenoisingLoopFunc(Protocol):
    def __call__(
        self, sigmas, video_state: LatentState, audio_state: LatentState, stepper, denoise_fn
    ) -> Tuple[LatentState, LatentState]: ...
