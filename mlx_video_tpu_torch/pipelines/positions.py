"""Position grids for video / audio RoPE.

The port's own copy of mlx_video_tpu/pipelines/positions.py (framework-free code, copied whole and
unchanged in behaviour), so that the port imports nothing of the JAX package.

Behavioral spec: reference mlx_video/generate.py:470-557. Host-side NumPy;
grids are computed once per resolution and fed to the jitted model.
"""

from __future__ import annotations

import numpy as np

# Audio constants (reference: generate.py:346-353)
AUDIO_SAMPLE_RATE = 24000
AUDIO_LATENT_SAMPLE_RATE = 16000
AUDIO_HOP_LENGTH = 160
AUDIO_LATENT_DOWNSAMPLE_FACTOR = 4
AUDIO_LATENT_CHANNELS = 8
AUDIO_MEL_BINS = 16
AUDIO_LATENTS_PER_SECOND = AUDIO_LATENT_SAMPLE_RATE / AUDIO_HOP_LENGTH / AUDIO_LATENT_DOWNSAMPLE_FACTOR  # 25


def create_position_grid(
    batch_size: int,
    num_frames: int,
    height: int,
    width: int,
    temporal_scale: int = 8,
    spatial_scale: int = 32,
    fps: float = 24.0,
    causal_fix: bool = True,
) -> np.ndarray:
    """Pixel-space (t, h, w) interval grid, shape (B, 3, F*H*W, 2)
    (reference: generate.py:470-525).

    Latent coordinates are scaled to pixel space by (temporal_scale,
    spatial_scale, spatial_scale); the causal fix shifts the time axis by
    ``1 - temporal_scale`` (clamped at 0) so the first latent frame maps to
    pixel frame 0; time is divided by fps (seconds).
    """
    t_coords = np.arange(num_frames)
    h_coords = np.arange(height)
    w_coords = np.arange(width)
    t_grid, h_grid, w_grid = np.meshgrid(t_coords, h_coords, w_coords, indexing="ij")
    starts = np.stack([t_grid, h_grid, w_grid], axis=0)
    ends = starts + 1

    coords = np.stack([starts, ends], axis=-1).reshape(3, num_frames * height * width, 2)
    coords = np.tile(coords[None], (batch_size, 1, 1, 1))

    scale = np.array([temporal_scale, spatial_scale, spatial_scale]).reshape(1, 3, 1, 1)
    pixel = (coords * scale).astype(np.float32)

    if causal_fix:
        pixel[:, 0] = np.clip(pixel[:, 0] + 1 - temporal_scale, 0, None)
    pixel[:, 0] = pixel[:, 0] / fps
    return pixel


def create_audio_position_grid(
    batch_size: int,
    audio_frames: int,
    sample_rate: int = AUDIO_LATENT_SAMPLE_RATE,
    hop_length: int = AUDIO_HOP_LENGTH,
    downsample_factor: int = AUDIO_LATENT_DOWNSAMPLE_FACTOR,
    is_causal: bool = True,
) -> np.ndarray:
    """Temporal interval grid for audio RoPE, shape (B, 1, T, 2)
    (reference: generate.py:528-551)."""

    def latent_time_sec(start: int, end: int) -> np.ndarray:
        latent_frame = np.arange(start, end, dtype=np.float32)
        mel_frame = latent_frame * downsample_factor
        if is_causal:
            mel_frame = np.clip(mel_frame + 1 - downsample_factor, 0, None)
        return mel_frame * hop_length / sample_rate

    start_times = latent_time_sec(0, audio_frames)
    end_times = latent_time_sec(1, audio_frames + 1)
    positions = np.stack([start_times, end_times], axis=-1)[None, None]
    return np.tile(positions, (batch_size, 1, 1, 1)).astype(np.float32)


def compute_audio_frames(num_video_frames: int, fps: float) -> int:
    """Audio latent frames for a video duration (reference: generate.py:554-557)."""
    return round(num_video_frames / fps * AUDIO_LATENTS_PER_SECOND)
