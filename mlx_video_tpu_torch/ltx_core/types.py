"""Shape NamedTuples + LatentState over torch tensors.

Counterpart of ltx_core/types.py (reference ltx_core/types.py:
VideoPixelShape, SpatioTemporalScaleFactors, VideoLatentShape,
AudioLatentShape, LatentState).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch


class VideoPixelShape(NamedTuple):
    batch: int
    frames: int
    height: int
    width: int
    fps: float = 24.0


class SpatioTemporalScaleFactors(NamedTuple):
    time: int
    width: int
    height: int

    @classmethod
    def default(cls) -> "SpatioTemporalScaleFactors":
        return cls(time=8, width=32, height=32)


VIDEO_SCALE_FACTORS = SpatioTemporalScaleFactors.default()


class VideoLatentShape(NamedTuple):
    batch: int
    channels: int
    frames: int
    height: int
    width: int

    def to_shape(self) -> Tuple[int, int, int, int, int]:
        return tuple(self)

    @staticmethod
    def from_shape(shape) -> "VideoLatentShape":
        return VideoLatentShape(*shape[:5])

    def mask_shape(self) -> "VideoLatentShape":
        return self._replace(channels=1)

    @staticmethod
    def from_pixel_shape(
        shape: VideoPixelShape,
        latent_channels: int = 128,
        scale_factors: SpatioTemporalScaleFactors = VIDEO_SCALE_FACTORS,
    ) -> "VideoLatentShape":
        return VideoLatentShape(
            batch=shape.batch,
            channels=latent_channels,
            frames=(shape.frames - 1) // scale_factors.time + 1,
            height=shape.height // scale_factors.height,
            width=shape.width // scale_factors.width,
        )

    def upscale(
        self, scale_factors: SpatioTemporalScaleFactors = VIDEO_SCALE_FACTORS
    ) -> "VideoLatentShape":
        return self._replace(
            channels=3,
            frames=(self.frames - 1) * scale_factors.time + 1,
            height=self.height * scale_factors.height,
            width=self.width * scale_factors.width,
        )


class AudioLatentShape(NamedTuple):
    batch: int
    channels: int
    frames: int
    mel_bins: int

    def to_shape(self) -> Tuple[int, int, int, int]:
        return tuple(self)

    @staticmethod
    def from_shape(shape) -> "AudioLatentShape":
        return AudioLatentShape(*shape[:4])

    def mask_shape(self) -> "AudioLatentShape":
        # one mask value per latent frame (reference: ltx_core/types.py:97-98):
        # the patchified mask is (B, F, 1) and broadcasts over (B, F, C*mel)
        return self._replace(channels=1, mel_bins=1)

    @staticmethod
    def from_duration(
        batch: int,
        duration: float,
        channels: int = 8,
        mel_bins: int = 16,
        sample_rate: int = 16000,
        hop_length: int = 160,
        audio_latent_downsample_factor: int = 4,
    ) -> "AudioLatentShape":
        """(reference: ltx_core/types.py:110-126)."""
        latents_per_second = (
            float(sample_rate) / float(hop_length) / float(audio_latent_downsample_factor)
        )
        return AudioLatentShape(
            batch=batch,
            channels=channels,
            frames=round(duration * latents_per_second),
            mel_bins=mel_bins,
        )

    @staticmethod
    def from_video_pixel_shape(
        shape: "VideoPixelShape",
        channels: int = 8,
        mel_bins: int = 16,
        sample_rate: int = 16000,
        hop_length: int = 160,
        audio_latent_downsample_factor: int = 4,
    ) -> "AudioLatentShape":
        """(reference: ltx_core/types.py:128-145)."""
        return AudioLatentShape.from_duration(
            batch=shape.batch,
            duration=float(shape.frames) / float(shape.fps),
            channels=channels,
            mel_bins=mel_bins,
            sample_rate=sample_rate,
            hop_length=hop_length,
            audio_latent_downsample_factor=audio_latent_downsample_factor,
        )


@dataclass
class LatentState:
    """(latent, clean_latent, denoise_mask, positions) working state."""

    latent: torch.Tensor
    denoise_mask: torch.Tensor
    clean_latent: torch.Tensor
    positions: Optional[torch.Tensor] = None

    def clone(self) -> "LatentState":
        return LatentState(
            latent=self.latent,
            denoise_mask=self.denoise_mask,
            clean_latent=self.clean_latent,
            positions=self.positions,
        )
