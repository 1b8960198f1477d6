"""Video generation: the distilled text-to-video pipeline (stage-1 denoise, 2x
latent upsample, renoise, stage-2 refine, VAE decode) and the dev pipeline
(single stage, classifier-free guidance over the ``ltx2_scheduler`` schedule,
optional image conditioning through the VAE encoder, VAE decode).

Counterpart of the distilled text-to-video and the dev branches of
mlx_video_tpu/pipelines/generate.py:generate_video, with ``decode_latents``
and the helpers they need. The text conditioning arrives as precomputed
embeddings (and, for CFG, negative embeddings), as the JAX CLI's
``--embeddings`` path gives it. Not ported yet, and refused by name: the
keyframe and IC-LoRA pipelines, video conditionings, image conditioning of
the distilled pipeline, audio, CFG refinement, the dials and multi-video
batches.

Differences from the JAX function, on purpose:
- All randomness comes from one ``torch.Generator``, in this order:
  distilled, the stage-1 noise, the stage-2 renoise and the decode noise;
  dev, the initial noise (masked by the conditioning state) and the decode
  noise.
- The video is decoded whether or not ``output_path`` is given; the mp4 is
  written only when it is. The untiled decode reads back fp32.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mlx_video_tpu_torch.config import LTXModelConfig, VideoVAEConfig
from mlx_video_tpu_torch.io import media
from mlx_video_tpu_torch.models.ltx.model import LTXModel
from mlx_video_tpu_torch.models.ltx.upsampler import LatentUpsampler, upsample_latents
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import (
    DecoderConfig,
    VideoDecoder,
    video_decoder_apply,
)
from mlx_video_tpu_torch.models.ltx.video_vae.encoder import VideoEncoder, video_encoder_apply
from mlx_video_tpu_torch.models.ltx.video_vae.tiling import TilingConfig, decode_with_tiling
from mlx_video_tpu_torch.pipelines import denoise as dn
from mlx_video_tpu_torch.pipelines.conditioning import (
    LatentState,
    VideoConditionByLatentIndex,
    add_noise_with_state,
    apply_conditioning,
)
from mlx_video_tpu_torch.pipelines.positions import create_position_grid
from mlx_video_tpu_torch.pipelines.schedulers import (
    STAGE_1_SIGMAS,
    STAGE_2_SIGMAS,
    ltx2_scheduler,
    subsample_refinement_sigmas,
    subsample_sigmas,
)

SPATIAL_SCALE = 32
TEMPORAL_SCALE = 8


class PipelineType(Enum):
    """Pipeline selector (reference: generate.py:299-305)."""

    DISTILLED = "distilled"
    DEV = "dev"
    KEYFRAME = "keyframe"
    IC_LORA = "ic_lora"


@dataclass
class ModelBundle:
    """The model components the pipelines run: the distilled pipeline needs
    the upsampler, image conditioning the VAE encoder."""

    transformer: LTXModel
    transformer_config: LTXModelConfig
    vae_decoder: VideoDecoder
    vae_decoder_config: DecoderConfig
    upsampler: Optional[LatentUpsampler] = None
    vae_encoder: Optional[VideoEncoder] = None
    vae_encoder_config: Optional[VideoVAEConfig] = None

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
    video_neg_embeddings: Optional[torch.Tensor] = None  # the negative prompt, for CFG


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


def _resolve_frame_idx(frame_idx: int, num_frames: int, latent_frames: int) -> int:
    """Map a video-frame index to a latent-frame index: identity when it
    already fits the latent grid, else a proportional rescale (the CLI's
    --image-frame-idx is in media frames)."""
    if frame_idx < latent_frames:
        return frame_idx
    if num_frames <= 1 or latent_frames <= 1:
        return 0
    scaled = int((frame_idx / (num_frames - 1) * (latent_frames - 1)) + 0.5)
    return int(max(0, min(latent_frames - 1, scaled)))


def _encode_conditionings(
    models: ModelBundle,
    images: Sequence[Tuple[str, int, float]],
    height: int,
    width: int,
    num_frames: int,
    dtype,
) -> List[VideoConditionByLatentIndex]:
    """VAE-encode image conditionings (path, frame index, strength) at one
    resolution, for replace mode."""
    if models.vae_encoder is None:
        raise ValueError("Image/video conditioning requires a loaded VAE encoder")
    device = next(models.vae_encoder.parameters()).device
    latent_frames = 1 + (num_frames - 1) // TEMPORAL_SCALE
    conds = []
    for img_path, frame_idx, strength in images:
        image = media.load_image(img_path, height=height, width=width)
        tensor = torch.from_numpy(media.prepare_image_for_encoding(image, height, width)).to(device, dtype)
        latent = video_encoder_apply(models.vae_encoder, models.vae_encoder_config, tensor)
        conds.append(VideoConditionByLatentIndex(
            latent=latent, frame_idx=_resolve_frame_idx(frame_idx, num_frames, latent_frames), strength=strength,
        ))
    return conds


def _init_state_with_conditioning(
    shape, conds, generator: torch.Generator, sigma0: float, dtype, device
) -> Tuple[torch.Tensor, Optional[LatentState]]:
    """The initial latent: with conditionings, the conditioned zero state
    renoised by its mask at sigma0; without, plain noise."""
    if conds:
        state = LatentState(
            latent=torch.zeros(shape, dtype=dtype, device=device),
            clean_latent=torch.zeros(shape, dtype=dtype, device=device),
            denoise_mask=torch.ones((shape[0], 1, shape[2], 1, 1), dtype=dtype, device=device),
        )
        state = add_noise_with_state(apply_conditioning(state, conds), sigma0, generator=generator)
        return state.latent, state
    draw = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return draw.to(device=device, dtype=dtype), None


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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mlx_video_tpu_torch yet (ROADMAP.md queue: Conditioning pipelines)"
    )


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
    pipeline: Union[PipelineType, str] = PipelineType.DISTILLED,
    cfg_scale: float = 4.0,
    num_inference_steps: int = 40,
    cfg_sequential: bool = False,
    images: Sequence[Tuple[str, int, float]] = (),
    video_conditionings: Sequence[Tuple[str, int, float]] = (),
    output_path: Optional[Union[str, Path]] = None,
    tiling: str = "auto",
    decode_latents_only: bool = False,
    dtype=torch.bfloat16,
    video_encoder: str = "ffmpeg",
) -> GenerateResult:
    """Generate a video with the distilled two-stage pipeline or the dev
    pipeline.

    Distilled: ``stage1_steps`` and ``stage2_steps`` of the distilled
    schedules around the 2x upsample. Dev: ``num_inference_steps`` of
    ``ltx2_scheduler`` at the latent token count, with CFG at ``cfg_scale``
    when ``text.video_neg_embeddings`` is given (batched over a doubled batch,
    or two passes with ``cfg_sequential``), and ``images`` — (path, frame
    index, strength) triples — VAE-encoded and placed in the initial latent
    (replace mode). ``generator`` (default: seeded from ``seed`` on the
    model's device) draws all noise. Returns the final latents and, unless
    ``decode_latents_only``, the decoded video; with ``output_path`` the video
    is also written as an mp4 by ``video_encoder`` (``ffmpeg``, falling back
    to cv2; or ``cv2``).
    """
    pipeline = PipelineType(pipeline)
    if pipeline in (PipelineType.KEYFRAME, PipelineType.IC_LORA):
        raise _not_ported(f"The {pipeline.value!r} pipeline")
    if video_conditionings:
        raise _not_ported("Video conditioning")
    if images and pipeline == PipelineType.DISTILLED:
        raise _not_ported("Image conditioning of the distilled pipeline")
    device = models.transformer.video.scale_shift_table.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    times: Dict[str, float] = {}
    dev = pipeline == PipelineType.DEV

    height, width, crop = pad_dimensions(height, width, 32 if dev else 64)
    num_frames = round_frames(num_frames)
    config = models.transformer_config
    latent_channels = config.in_channels
    latent_frames = 1 + (num_frames - 1) // TEMPORAL_SCALE
    latent_h, latent_w = height // SPATIAL_SCALE, width // SPATIAL_SCALE
    tiling_config = select_tiling(tiling, height, width, num_frames)
    _check_params_dtype(models, dtype)
    context = text.video_embeddings.to(device=device, dtype=dtype)

    def noise(shape) -> torch.Tensor:
        draw = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
        return draw.to(device=device, dtype=dtype)

    def positions(h: int, w: int) -> torch.Tensor:
        return torch.from_numpy(create_position_grid(1, latent_frames, h, w)).to(device)

    if dev:
        conds = []
        if images:
            with _phase(times, "cond_encode", device):
                conds = _encode_conditionings(models, images, height, width, num_frames, dtype)
        sigmas = ltx2_scheduler(steps=num_inference_steps, num_tokens=latent_frames * latent_h * latent_w)
        shape = (1, latent_channels, latent_frames, latent_h, latent_w)
        latents, state = _init_state_with_conditioning(shape, conds, generator, float(sigmas[0]), dtype, device)
        neg = text.video_neg_embeddings
        with _phase(times, "dev_denoise", device):
            latents = dn.denoise(
                models.transformer, config, latents, positions(latent_h, latent_w), context, sigmas,
                neg_context=None if neg is None else neg.to(device=device, dtype=dtype),
                cfg_scale=cfg_scale, state=state, cfg_sequential=cfg_sequential,
            )
    else:
        if not 1 <= stage1_steps <= len(STAGE_1_SIGMAS) - 1:
            raise ValueError(f"stage1_steps must be between 1 and {len(STAGE_1_SIGMAS) - 1}.")
        if stage2_steps not in (1, 2, 3):
            raise ValueError("stage2_steps must be 1, 2, or 3.")
        if models.upsampler is None:
            raise ValueError("Distilled pipeline requires upsampler weights")
        s1_sigmas = subsample_sigmas(STAGE_1_SIGMAS, stage1_steps, "farthest")
        s2_sigmas = subsample_refinement_sigmas(STAGE_2_SIGMAS, stage2_steps, "farthest")

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
