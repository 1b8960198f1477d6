"""Distilled text-to-video generation: stage-1 denoise, 2x latent upsample,
renoise, stage-2 refine, VAE decode.

Counterpart of the distilled text-to-video branch of
mlx_video_tpu/pipelines/generate.py:generate_video (no conditioning, audio,
CFG refinement, dials or multi-video batches yet), with ``decode_latents``
and the helpers it needs. The text conditioning arrives as precomputed
embeddings, as the JAX CLI's ``--embeddings`` path gives it.

Differences from the JAX function, on purpose:
- All randomness (stage-1 noise, stage-2 renoise, decode noise) comes from
  one ``torch.Generator``, in that order.
- The video is decoded whether or not ``output_path`` is given; the mp4 is
  written only when it is. The untiled decode reads back fp32.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from mlx_video_tpu.io import media
from mlx_video_tpu.models.ltx.video_vae.tiling import TilingConfig, decode_with_tiling
from mlx_video_tpu.pipelines.positions import create_position_grid
from mlx_video_tpu.pipelines.schedulers import (
    STAGE_1_SIGMAS,
    STAGE_2_SIGMAS,
    subsample_refinement_sigmas,
    subsample_sigmas,
)
from mlx_video_tpu_torch.config import LTXModelConfig
from mlx_video_tpu_torch.models.ltx.model import LTXModel
from mlx_video_tpu_torch.models.ltx.upsampler import LatentUpsampler, upsample_latents
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import (
    DecoderConfig,
    VideoDecoder,
    video_decoder_apply,
)
from mlx_video_tpu_torch.pipelines import denoise as dn

SPATIAL_SCALE = 32
TEMPORAL_SCALE = 8


@dataclass
class ModelBundle:
    """The model components the distilled pipeline runs."""

    transformer: LTXModel
    transformer_config: LTXModelConfig
    vae_decoder: VideoDecoder
    vae_decoder_config: DecoderConfig
    upsampler: Optional[LatentUpsampler] = None

    @property
    def latents_mean(self) -> torch.Tensor:
        return self.vae_decoder.latents_mean

    @property
    def latents_std(self) -> torch.Tensor:
        return self.vae_decoder.latents_std


@dataclass
class TextConditioning:
    """Precomputed text context."""

    video_embeddings: torch.Tensor  # (B, S_ctx, caption_channels)


@dataclass
class GenerateResult:
    video_path: Optional[Path]
    latents: np.ndarray
    video: Optional[np.ndarray] = None  # (B, 3, F, H, W) fp32 in [-1, 1]
    phase_seconds: Dict[str, float] = field(default_factory=dict)


def pad_dimensions(height: int, width: int, divisor: int) -> Tuple[int, int, Optional[Tuple[int, int, int, int]]]:
    """Pad H/W up to a divisor, returning crop-back params."""
    if height % divisor == 0 and width % divisor == 0:
        return height, width, None
    pad_h = (divisor - height % divisor) % divisor
    pad_w = (divisor - width % divisor) % divisor
    return height + pad_h, width + pad_w, (pad_h // 2, pad_w // 2, height, width)


def round_frames(num_frames: int) -> int:
    """Round up to 1 + 8k."""
    if num_frames % 8 == 1:
        return num_frames
    return ((num_frames - 1 + 7) // 8) * 8 + 1


_TILING_PRESETS = {
    "default": TilingConfig.default,
    "aggressive": TilingConfig.aggressive,
    "conservative": TilingConfig.conservative,
    "spatial": TilingConfig.spatial_only,
    "temporal": TilingConfig.temporal_only,
}


def select_tiling(tiling: str, height: int, width: int, num_frames: int) -> Optional[TilingConfig]:
    """Decode tiling by preset name; "none" disables it and unknown names mean
    auto. (Streaming decode, which the JAX function also selects here, is not
    ported yet.)"""
    if tiling == "none":
        return None
    if tiling in _TILING_PRESETS:
        return _TILING_PRESETS[tiling]()
    return TilingConfig.auto(height, width, num_frames)


def decode_latents(
    models: ModelBundle,
    latents: torch.Tensor,
    tiling_config: Optional[TilingConfig],
    decode_timestep: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
) -> np.ndarray:
    """Tiled (or whole) VAE decode -> (B, 3, F, H, W) fp32 numpy in [-1, 1].

    ``generator`` draws the decode noise (none without it). A tiled decode
    blends on the host (tiling.decode_with_tiling), one decoder call per tile.
    """
    dec_cfg = models.vae_decoder_config
    device = latents.device
    timestep = None
    if decode_timestep is not None:
        timestep = torch.full((latents.shape[0],), decode_timestep, dtype=torch.float32, device=device)

    def decode(x: torch.Tensor) -> torch.Tensor:
        return video_decoder_apply(
            models.vae_decoder, dec_cfg, x, timestep=timestep, generator=generator
        )

    if tiling_config is None:
        return decode(latents).float().cpu().numpy()
    return decode_with_tiling(
        lambda tile: decode(torch.from_numpy(tile).to(device, latents.dtype)).float().cpu().numpy(),
        latents.float().cpu().numpy(),  # exact for bf16; tiles go back to latents.dtype
        tiling_config,
        spatial_scale=SPATIAL_SCALE,
        temporal_scale=TEMPORAL_SCALE,
    )


def _check_params_dtype(models: ModelBundle, dtype) -> None:
    # the output table is never quantized; any linear may be a QuantLinear
    got = models.transformer.video.scale_shift_table.dtype
    if got != dtype:
        raise ValueError(
            f"transformer params are {got} but the pipeline dtype is {dtype}; "
            f"build the weights in the pipeline dtype or pass dtype={got}"
        )


@contextmanager
def _phase(times: Dict[str, float], name: str, device: torch.device):
    """Wall time of a phase, ended by a device synchronise on CUDA."""
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times[name] = time.perf_counter() - t0


@torch.no_grad()
def generate_video(
    models: ModelBundle,
    text: TextConditioning,
    height: int = 512,
    width: int = 512,
    num_frames: int = 33,
    fps: float = 24.0,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    stage1_steps: int = 8,
    stage2_steps: int = 3,
    output_path: Optional[Union[str, Path]] = None,
    tiling: str = "auto",
    decode_latents_only: bool = False,
    dtype=torch.bfloat16,
    video_encoder: str = "ffmpeg",
) -> GenerateResult:
    """Distilled two-stage text-to-video generation.

    ``generator`` (default: seeded from ``seed`` on the model's device) draws
    the stage-1 noise, the stage-2 renoise and the decode noise. Returns the
    final latents and, unless ``decode_latents_only``, the decoded video; with
    ``output_path`` the video is also written as an mp4 by ``video_encoder``
    (``ffmpeg``, falling back to cv2; or ``cv2``).
    """
    device = models.transformer.video.scale_shift_table.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    times: Dict[str, float] = {}

    height, width, crop = pad_dimensions(height, width, 64)
    num_frames = round_frames(num_frames)
    config = models.transformer_config
    latent_channels = config.in_channels
    latent_frames = 1 + (num_frames - 1) // TEMPORAL_SCALE
    latent_h, latent_w = height // SPATIAL_SCALE, width // SPATIAL_SCALE
    tiling_config = select_tiling(tiling, height, width, num_frames)

    if not 1 <= stage1_steps <= len(STAGE_1_SIGMAS) - 1:
        raise ValueError(f"stage1_steps must be between 1 and {len(STAGE_1_SIGMAS) - 1}.")
    if stage2_steps not in (1, 2, 3):
        raise ValueError("stage2_steps must be 1, 2, or 3.")
    if models.upsampler is None:
        raise ValueError("Distilled pipeline requires upsampler weights")
    _check_params_dtype(models, dtype)

    s1_sigmas = subsample_sigmas(STAGE_1_SIGMAS, stage1_steps, "farthest")
    s2_sigmas = subsample_refinement_sigmas(STAGE_2_SIGMAS, stage2_steps, "farthest")
    context = text.video_embeddings.to(device=device, dtype=dtype)

    def noise(shape) -> torch.Tensor:
        draw = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
        return draw.to(device=device, dtype=dtype)

    def positions(h: int, w: int) -> torch.Tensor:
        return torch.from_numpy(create_position_grid(1, latent_frames, h, w)).to(device)

    with _phase(times, "stage1_denoise", device):
        shape1 = (1, latent_channels, latent_frames, latent_h // 2, latent_w // 2)
        latents = dn.denoise(
            models.transformer, config, noise(shape1),
            positions(latent_h // 2, latent_w // 2), context, s1_sigmas,
        )

    with _phase(times, "upsample", device):
        latents = upsample_latents(models.upsampler, latents, models.latents_mean, models.latents_std)

    with _phase(times, "stage2_denoise", device):
        sigma0 = s2_sigmas[0]
        latents = noise(latents.shape) * sigma0 + latents * (1.0 - sigma0)
        latents = dn.denoise(
            models.transformer, config, latents, positions(latent_h, latent_w), context, s2_sigmas
        )

    latents_np = latents.float().cpu().numpy()
    if decode_latents_only:
        return GenerateResult(video_path=None, latents=latents_np, phase_seconds=times)

    with _phase(times, "vae_decode", device):
        video = decode_latents(models, latents, tiling_config, decode_timestep=0.05, generator=generator)

    video_path = None
    if output_path is not None:
        video_path = Path(output_path)
        frames = media.frames_to_uint8(video)[:num_frames]
        if crop is not None:
            top, left, out_h, out_w = crop
            frames = frames[:, top : top + out_h, left : left + out_w]
        writer = media.VideoWriter(video_path, frames.shape[2], frames.shape[1], fps, encoder=video_encoder)
        try:
            writer.write(frames)
        finally:
            writer.close()
    return GenerateResult(video_path=video_path, latents=latents_np, video=video, phase_seconds=times)
