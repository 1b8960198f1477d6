"""Video/audio patchifiers and the pixel-coordinate mapping, on tensors.

Counterpart of ltx_core/components/patchifiers.py (reference
ltx_core/components/patchifiers.py:12-149). The grid bounds are fp32
tensors on ``device`` (the CPU when it is not given).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from mlx_video_tpu_torch.ltx_core.types import AudioLatentShape, SpatioTemporalScaleFactors, VideoLatentShape
from mlx_video_tpu_torch.ltx_core.utils import device_or_card


class VideoLatentPatchifier:
    def __init__(self, patch_size: int):
        self._patch_size = (1, patch_size, patch_size)

    @property
    def patch_size(self) -> Tuple[int, int, int]:
        return self._patch_size

    def get_token_count(self, tgt_shape: VideoLatentShape) -> int:
        return math.prod(tgt_shape.to_shape()[2:]) // math.prod(self._patch_size)

    def patchify(self, latents: torch.Tensor) -> torch.Tensor:
        b, c, f, h, w = latents.shape
        p1, p2, p3 = self._patch_size
        if f % p1 or h % p2 or w % p3:
            raise ValueError("Latents not divisible by patch size")
        x = latents.reshape(b, c, f // p1, p1, h // p2, p2, w // p3, p3)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
        return x.reshape(b, (f // p1) * (h // p2) * (w // p3), c * p1 * p2 * p3)

    def unpatchify(self, latents: torch.Tensor, output_shape: VideoLatentShape) -> torch.Tensor:
        p1, p2, p3 = self._patch_size
        if p1 != 1:
            raise ValueError("Temporal patch size must be 1 for symmetric patchifier")
        b, c = output_shape.batch, output_shape.channels
        f, h, w = output_shape.frames, output_shape.height // p2, output_shape.width // p3
        x = latents.reshape(b, f, h, w, c, p1, p2, p3)
        x = x.permute(0, 4, 1, 5, 2, 6, 3, 7)
        return x.reshape(b, c, output_shape.frames, output_shape.height, output_shape.width)

    def get_patch_grid_bounds(self, output_shape: VideoLatentShape, device=None) -> torch.Tensor:
        if not isinstance(output_shape, VideoLatentShape):
            raise ValueError("VideoLatentPatchifier expects VideoLatentShape")
        p = self._patch_size
        gf = np.arange(0, output_shape.frames, p[0])
        gh = np.arange(0, output_shape.height, p[1])
        gw = np.arange(0, output_shape.width, p[2])
        grids = np.meshgrid(gf, gh, gw, indexing="ij")
        starts = np.stack(grids, axis=0)
        ends = starts + np.asarray(p).reshape(3, 1, 1, 1)
        coords = np.stack((starts, ends), axis=-1).reshape(3, -1, 2)[None]
        coords = np.broadcast_to(coords, (output_shape.batch,) + coords.shape[1:])
        return torch.from_numpy(coords.astype(np.float32)).to(device_or_card(device))


def get_pixel_coords(
    latent_coords: torch.Tensor,
    scale_factors: SpatioTemporalScaleFactors,
    causal_fix: bool = False,
) -> torch.Tensor:
    """Latent coordinates -> pixel space with the causal first-frame fix
    (reference: patchifiers.py:75-89)."""
    scale = torch.tensor(tuple(scale_factors), dtype=latent_coords.dtype,
                         device=latent_coords.device).reshape(1, 3, 1, 1)
    pixel = latent_coords * scale
    if causal_fix:
        adjusted = torch.clamp(pixel[:, 0] + 1 - scale_factors.time, min=0)
        pixel = torch.cat([adjusted[:, None], pixel[:, 1:]], dim=1)
    return pixel


class AudioPatchifier:
    def __init__(
        self,
        patch_size: int,
        sample_rate: int = 16000,
        hop_length: int = 160,
        audio_latent_downsample_factor: int = 4,
        is_causal: bool = True,
        shift: int = 0,
    ):
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.audio_latent_downsample_factor = audio_latent_downsample_factor
        self.is_causal = is_causal
        self.shift = shift
        self._patch_size = (1, patch_size, patch_size)

    @property
    def patch_size(self) -> Tuple[int, int, int]:
        return self._patch_size

    def get_token_count(self, tgt_shape: AudioLatentShape) -> int:
        return tgt_shape.frames

    def _latent_time_sec(self, start: int, end: int) -> np.ndarray:
        frame = np.arange(start, end)
        mel = frame * self.audio_latent_downsample_factor
        if self.is_causal:
            mel = mel + 1
        return (mel * self.hop_length) / self.sample_rate

    def patchify(self, audio_latents: torch.Tensor) -> torch.Tensor:
        b, c, t, f = audio_latents.shape
        return audio_latents.permute(0, 2, 1, 3).reshape(b, t, c * f)

    def unpatchify(self, audio_latents: torch.Tensor, output_shape: AudioLatentShape) -> torch.Tensor:
        b, t, _ = audio_latents.shape
        c, f = output_shape.channels, output_shape.mel_bins
        return audio_latents.reshape(b, t, c, f).permute(0, 2, 1, 3)

    def get_patch_grid_bounds(self, output_shape: AudioLatentShape, device=None) -> torch.Tensor:
        if not isinstance(output_shape, AudioLatentShape):
            raise ValueError("AudioPatchifier expects AudioLatentShape")
        n = output_shape.frames
        starts = self._latent_time_sec(self.shift, n + self.shift)
        ends = self._latent_time_sec(self.shift + 1, n + self.shift + 1)
        coords = np.stack([starts, ends], axis=-1)[None, None]
        coords = np.broadcast_to(coords, (output_shape.batch, 1, n, 2))
        return torch.from_numpy(coords.astype(np.float32)).to(device_or_card(device))
