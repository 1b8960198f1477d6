"""Video generation: the distilled two-stage pipeline (stage-1 denoise at half
size, 2x latent upsample, renoise, stage-2 refine, VAE decode) with its
keyframe and IC-LoRA forms, and the dev pipeline (single stage,
classifier-free guidance over the ``ltx2_scheduler`` schedule, VAE decode).

Counterpart of the video-only branches of
mlx_video_tpu/pipelines/generate.py:generate_video, with ``decode_latents``,
``select_tiling`` and the helpers they need. The text conditioning arrives as
precomputed embeddings (and, for CFG, negative embeddings), as the JAX CLI's
``--embeddings`` path gives it. What the distilled branch adds to plain text
to video:
- conditionings, VAE-encoded at both stage sizes: images (replace mode, or
  guide mode in the keyframe pipeline) at stage 1 and stage 2, videos (always
  guide mode; the IC-LoRA pipeline needs one) at stage 1 only; stage 2
  renoises its conditioned state by the state's mask;
- a separate stage-2 transformer (``ModelBundle.stage2_transformer``), and
  CFG at stage 2 (``stage2_cfg``) when negative embeddings exist;
- ``num_videos`` videos through every denoise at batch N, decoded and written
  one at a time;
- streaming decode (``stream``): the writer gets frames as the tiled decode
  finalises them.
Not ported yet: audio, the TeaCache, PAB and CFG-cache dials, the parallel
and host-staging options.

Randomness: video i draws all its noise from its own ``torch.Generator``
(the one given, or one seeded with ``seed + i`` or ``seeds[i]`` on the
model's device), in this order: distilled, the stage-1 noise (with
conditionings, inside the mask-scaled renoise of the conditioned state),
the stage-2 renoise (with image conditionings, the masked renoise of the
stage-2 state) and the decode noise; dev, the initial noise (masked by the
conditioning state) and the decode noise. The order is the same with and
without conditionings, and a batch of N videos draws exactly the noise of N
single runs. (The JAX function splits one key into 8 and takes keys 0, 1
and 2 for the same three draws.)

Differences from the JAX function, on purpose:
- The video is decoded whether or not ``output_path`` is given; the mp4 is
  written only when it is.
- Decodes read back fp32 (the JAX function reads fp16 on an accelerator). A
  tiled decode of CUDA latents blends on the card
  (tiling.decode_with_tiling_device); on the CPU it blends on the host.
- The decode noise is drawn once for the whole latents and mixed in before
  tiling, so a streamed (tiled) decode sees the noise of an untiled one
  (the JAX decoder draws each tile's noise from the same key).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mlx_video_tpu_torch.config import LTXModelConfig, VideoVAEConfig
from mlx_video_tpu_torch.io import media
from mlx_video_tpu_torch.models.ltx.model import LTXModel
from mlx_video_tpu_torch.models.ltx.upsampler import LatentUpsampler, upsample_latents
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import (
    DecoderConfig,
    VideoDecoder,
    add_decode_noise,
    video_decoder_apply,
)
from mlx_video_tpu_torch.models.ltx.video_vae.encoder import VideoEncoder, video_encoder_apply
from mlx_video_tpu_torch.models.ltx.video_vae.tiling import (
    TilingConfig,
    decode_with_tiling,
    decode_with_tiling_device,
)
from mlx_video_tpu_torch.pipelines import denoise as dn
from mlx_video_tpu_torch.pipelines.conditioning import (
    LatentState,
    VideoCondition,
    VideoConditionByKeyframeIndex,
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
    the upsampler, conditionings the VAE encoder; ``stage2_transformer``,
    when given, refines stage 2 in place of ``transformer``."""

    transformer: LTXModel
    transformer_config: LTXModelConfig
    vae_decoder: VideoDecoder
    vae_decoder_config: DecoderConfig
    upsampler: Optional[LatentUpsampler] = None
    vae_encoder: Optional[VideoEncoder] = None
    vae_encoder_config: Optional[VideoVAEConfig] = None
    stage2_transformer: Optional[LTXModel] = None

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
    video: Optional[np.ndarray] = None  # (N, 3, F, H, W) fp32 in [-1, 1]
    phase_seconds: Dict[str, float] = field(default_factory=dict)
    video_paths: Optional[List[Path]] = None  # num_videos > 1: {stem}_{i}{suffix}, one a video


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
    videos: Sequence[Tuple[str, int, float]] = (),
    mode: str = "replace",
) -> List[VideoCondition]:
    """VAE-encode conditionings, each (path, frame index, strength), at one
    resolution: images as replace-mode conditionings, or keyframes in guide
    ``mode``; videos (their first ``num_frames`` frames) always as keyframes."""
    if models.vae_encoder is None:
        raise ValueError("Image/video conditioning requires a loaded VAE encoder")
    device = next(models.vae_encoder.parameters()).device
    latent_frames = 1 + (num_frames - 1) // TEMPORAL_SCALE

    def encode(pixels: np.ndarray) -> torch.Tensor:
        return video_encoder_apply(models.vae_encoder, models.vae_encoder_config,
                                   torch.from_numpy(pixels).to(device, dtype))

    conds: List[VideoCondition] = []
    for img_path, frame_idx, strength in images:
        image = media.load_image(img_path, height=height, width=width)
        latent = encode(media.prepare_image_for_encoding(image, height, width))
        idx = _resolve_frame_idx(frame_idx, num_frames, latent_frames)
        if mode == "guide":
            conds.append(VideoConditionByKeyframeIndex(keyframes=latent, frame_idx=idx, strength=strength))
        else:
            conds.append(VideoConditionByLatentIndex(latent=latent, frame_idx=idx, strength=strength))
    for vid_path, frame_idx, strength in videos:
        frames = media.load_video(vid_path, height=height, width=width, frame_cap=num_frames)
        latent = encode(media.prepare_video_for_encoding(frames, height, width))
        conds.append(VideoConditionByKeyframeIndex(
            keyframes=latent, frame_idx=_resolve_frame_idx(frame_idx, num_frames, latent_frames), strength=strength,
        ))
    return conds


def _conditioned_state(
    latent: torch.Tensor, conds, noise: Callable[[Tuple[int, ...]], torch.Tensor], sigma0: float
) -> LatentState:
    """``latent`` with the conditionings placed (clean latents and per-frame
    denoise masks), then renoised by its mask at sigma0 with ``noise(shape)``
    (the JAX function's ``_masked_renoise``)."""
    state = LatentState(
        latent=latent,
        clean_latent=torch.zeros_like(latent),
        denoise_mask=torch.ones((latent.shape[0], 1, latent.shape[2], 1, 1), dtype=latent.dtype,
                                device=latent.device),
    )
    return add_noise_with_state(apply_conditioning(state, conds), sigma0, noise=noise(latent.shape))


_TILING_PRESETS = {
    "default": TilingConfig.default,
    "aggressive": TilingConfig.aggressive,
    "conservative": TilingConfig.conservative,
    "spatial": TilingConfig.spatial_only,
    "temporal": TilingConfig.temporal_only,
}


def select_tiling(tiling: str, height: int, width: int, num_frames: int,
                  stream: bool = False) -> Optional[TilingConfig]:
    """Decode tiling by preset name; "none" disables it and unknown names mean
    auto. ``stream`` forces temporal tiles where there would be none, so that
    frames reach the writer before the whole video is decoded."""
    if tiling == "none":
        cfg = None
    elif tiling in _TILING_PRESETS:
        cfg = _TILING_PRESETS[tiling]()
    else:
        cfg = TilingConfig.auto(height, width, num_frames)
    if stream and cfg is None:
        tile_size = 64
        if num_frames < tile_size:
            tile_size = max(16, (num_frames // 8) * 8) or 16
        cfg = TilingConfig.temporal_only(tile_size=tile_size, overlap=24 if tile_size >= 64 else 8)
    return cfg


def decode_latents(
    models: ModelBundle,
    latents: torch.Tensor,
    tiling_config: Optional[TilingConfig],
    decode_timestep: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    on_frames_ready: Optional[Callable[[np.ndarray, int], None]] = None,
) -> np.ndarray:
    """Tiled (or whole) VAE decode -> (B, 3, F, H, W) fp32 numpy in [-1, 1].

    ``generator`` draws the decode noise (none without it), once for the
    whole latents, so the tiling leaves it unchanged. A tiled decode runs one
    decoder call per tile and blends on the card for CUDA latents
    (tiling.decode_with_tiling_device), on the host otherwise
    (tiling.decode_with_tiling). ``on_frames_ready(frames, start)`` receives
    each finalised frame range (the whole video when untiled).
    """
    dec_cfg = models.vae_decoder_config
    device = latents.device
    timestep = None
    if decode_timestep is not None:
        timestep = torch.full((latents.shape[0],), decode_timestep, dtype=torch.float32, device=device)
    latents = add_decode_noise(dec_cfg, latents, generator=generator)

    def decode(x: torch.Tensor) -> torch.Tensor:
        return video_decoder_apply(models.vae_decoder, dec_cfg, x, timestep=timestep)

    if tiling_config is None:
        out = decode(latents).float().cpu().numpy()
        if on_frames_ready is not None:
            on_frames_ready(out, 0)
        return out
    tiles = dict(spatial_scale=SPATIAL_SCALE, temporal_scale=TEMPORAL_SCALE, on_frames_ready=on_frames_ready)
    if device.type == "cuda":
        return decode_with_tiling_device(lambda tile: decode(tile.contiguous()).float(), latents, tiling_config,
                                         **tiles)
    return decode_with_tiling(
        lambda tile: decode(torch.from_numpy(tile).to(device, latents.dtype)).float().cpu().numpy(),
        latents.float().cpu().numpy(),  # exact for bf16; tiles go back to latents.dtype
        tiling_config,
        **tiles,
    )


def _check_params_dtype(models: ModelBundle, dtype) -> None:
    # the output table is never quantized; any linear may be a QuantLinear
    for model in (models.transformer, models.stage2_transformer):
        got = None if model is None else model.video.scale_shift_table.dtype
        if got is not None and got != dtype:
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


def _per_video(x: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    """Text embeddings of batch 1 broadcast to ``n`` videos (or already n)."""
    if x is None or x.shape[0] == n:
        return x
    if x.shape[0] == 1:
        return x.expand(n, *x.shape[1:])
    raise ValueError(f"text conditioning batch {x.shape[0]} does not match num_videos={n} "
                     "(pass 1 prompt to broadcast or N)")


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
    num_videos: int = 1,
    seeds: Optional[Sequence[int]] = None,
    stage1_steps: int = 8,
    stage2_steps: int = 3,
    sigma_subsample: str = "farthest",
    stage2_cfg: bool = False,
    pipeline: Union[PipelineType, str] = PipelineType.DISTILLED,
    cfg_scale: float = 4.0,
    num_inference_steps: int = 40,
    cfg_sequential: bool = False,
    images: Sequence[Tuple[str, int, float]] = (),
    video_conditionings: Sequence[Tuple[str, int, float]] = (),
    output_path: Optional[Union[str, Path]] = None,
    tiling: str = "auto",
    stream: bool = False,
    decode_latents_only: bool = False,
    dtype=torch.bfloat16,
    video_encoder: str = "ffmpeg",
) -> GenerateResult:
    """Generate videos with the distilled two-stage pipeline (``distilled``,
    ``keyframe``, ``ic_lora``) or the dev pipeline.

    Distilled: ``stage1_steps`` and ``stage2_steps`` of the distilled
    schedules (subsampled ``sigma_subsample``: "farthest" or "uniform")
    around the 2x upsample; stage 2 runs ``models.stage2_transformer`` if
    given, with CFG at ``cfg_scale`` when ``stage2_cfg`` and
    ``text.video_neg_embeddings`` are given. ``images`` and
    ``video_conditionings`` are (path, frame index, strength) triples, VAE
    encoded: images in replace mode (guide mode for ``keyframe``), videos as
    keyframes (``ic_lora`` needs one; ``dev`` takes none). Dev:
    ``num_inference_steps`` of ``ltx2_scheduler`` at the latent token count,
    with CFG at ``cfg_scale`` when ``text.video_neg_embeddings`` is given, and
    ``images`` in replace mode. CFG is batched over a doubled batch, or two
    passes with ``cfg_sequential``.

    ``num_videos`` videos (no conditionings) share every denoise at batch N;
    video i draws its noise from a generator seeded with ``seed + i`` or
    ``seeds[i]`` (``generator``, for one video, replaces the seeded one).
    Returns the final latents and, unless ``decode_latents_only``, the decoded
    videos; with ``output_path`` each video is also written as an mp4 by
    ``video_encoder`` (``ffmpeg``, falling back to cv2; or ``cv2``), to
    ``{stem}_{i}{suffix}`` when there are several, and with ``stream`` the
    writer gets frames as the tiled decode finalises them.
    """
    pipeline = PipelineType(pipeline)
    if seeds is not None:
        if not seeds:
            raise ValueError("seeds must be non-empty")
        if num_videos == 1:
            num_videos = len(seeds)
        elif len(seeds) != num_videos:
            raise ValueError(f"len(seeds)={len(seeds)} != num_videos={num_videos}")
    if num_videos < 1:
        raise ValueError("num_videos must be >= 1")
    if pipeline == PipelineType.IC_LORA and not video_conditionings:
        raise ValueError("IC-LoRA pipeline requires video conditionings")
    if pipeline == PipelineType.DEV and video_conditionings:
        raise ValueError("Video conditioning is only supported in ic_lora/distilled pipelines.")
    if sigma_subsample not in ("uniform", "farthest"):
        raise ValueError("sigma_subsample must be 'uniform' or 'farthest'.")
    if num_videos > 1 and (images or video_conditionings):
        raise ValueError("num_videos > 1 does not compose with image/video conditioning")
    if generator is not None and num_videos > 1:
        raise ValueError("generator draws one video's noise; give seed or seeds for num_videos > 1")
    device = models.transformer.video.scale_shift_table.device
    vid_seeds = [int(s) for s in seeds] if seeds is not None else [seed + i for i in range(num_videos)]
    generators = [generator] if generator is not None else [
        torch.Generator(device=device).manual_seed(s) for s in vid_seeds]
    times: Dict[str, float] = {}
    dev = pipeline == PipelineType.DEV
    conditioning_mode = "guide" if pipeline == PipelineType.KEYFRAME else "replace"

    height, width, crop = pad_dimensions(height, width, 32 if dev else 64)
    num_frames = round_frames(num_frames)
    config = models.transformer_config
    latent_channels = config.in_channels
    latent_frames = 1 + (num_frames - 1) // TEMPORAL_SCALE
    latent_h, latent_w = height // SPATIAL_SCALE, width // SPATIAL_SCALE
    tiling_config = select_tiling(tiling, height, width, num_frames, stream)
    _check_params_dtype(models, dtype)
    context = _per_video(text.video_embeddings.to(device=device, dtype=dtype), num_videos)
    neg = text.video_neg_embeddings
    neg = None if neg is None else _per_video(neg.to(device=device, dtype=dtype), num_videos)

    def noise(shape) -> torch.Tensor:
        """fp32 draws for (N, ...) latents, video i's slice from generator i,
        cast to the pipeline dtype on the device."""
        draws = [torch.randn((1, *shape[1:]), generator=g, device=g.device, dtype=torch.float32) for g in generators]
        return torch.cat(draws).to(device=device, dtype=dtype)

    def zeros(shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=device)

    def positions(h: int, w: int) -> torch.Tensor:
        return torch.from_numpy(create_position_grid(num_videos, latent_frames, h, w)).to(device)

    if dev:
        conds = []
        if images:
            with _phase(times, "cond_encode", device):
                conds = _encode_conditionings(models, images, height, width, num_frames, dtype)
        sigmas = ltx2_scheduler(steps=num_inference_steps, num_tokens=latent_frames * latent_h * latent_w)
        shape = (num_videos, latent_channels, latent_frames, latent_h, latent_w)
        state = _conditioned_state(zeros(shape), conds, noise, float(sigmas[0])) if conds else None
        latents = noise(shape) if state is None else state.latent
        with _phase(times, "dev_denoise", device):
            latents = dn.denoise(
                models.transformer, config, latents, positions(latent_h, latent_w), context, sigmas,
                neg_context=neg, cfg_scale=cfg_scale, state=state, cfg_sequential=cfg_sequential,
            )
    else:
        if not 1 <= stage1_steps <= len(STAGE_1_SIGMAS) - 1:
            raise ValueError(f"stage1_steps must be between 1 and {len(STAGE_1_SIGMAS) - 1}.")
        if stage2_steps not in (1, 2, 3):
            raise ValueError("stage2_steps must be 1, 2, or 3.")
        if models.upsampler is None:
            raise ValueError("Distilled pipeline requires upsampler weights")
        s1_sigmas = subsample_sigmas(STAGE_1_SIGMAS, stage1_steps, sigma_subsample)
        s2_sigmas = subsample_refinement_sigmas(STAGE_2_SIGMAS, stage2_steps, sigma_subsample)

        s1_conds = s2_conds = []
        if images or video_conditionings:
            with _phase(times, "cond_encode", device):
                s1_conds = _encode_conditionings(models, images, height // 2, width // 2, num_frames, dtype,
                                                 videos=video_conditionings, mode=conditioning_mode)
                s2_conds = _encode_conditionings(models, images, height, width, num_frames, dtype,
                                                 mode=conditioning_mode)

        with _phase(times, "stage1_denoise", device):
            shape1 = (num_videos, latent_channels, latent_frames, latent_h // 2, latent_w // 2)
            state1 = _conditioned_state(zeros(shape1), s1_conds, noise, s1_sigmas[0]) if s1_conds else None
            latents = dn.denoise(
                models.transformer, config, noise(shape1) if state1 is None else state1.latent,
                positions(latent_h // 2, latent_w // 2), context, s1_sigmas, state=state1,
            )

        with _phase(times, "upsample", device):
            latents = upsample_latents(models.upsampler, latents, models.latents_mean, models.latents_std)

        with _phase(times, "stage2_denoise", device):
            sigma0 = s2_sigmas[0]
            state2 = _conditioned_state(latents, s2_conds, noise, sigma0) if s2_conds else None
            latents = noise(latents.shape) * sigma0 + latents * (1.0 - sigma0) if state2 is None else state2.latent
            stage2 = models.stage2_transformer if models.stage2_transformer is not None else models.transformer
            latents = dn.denoise(
                stage2, config, latents, positions(latent_h, latent_w), context, s2_sigmas,
                neg_context=neg if stage2_cfg else None, cfg_scale=cfg_scale, state=state2,
                cfg_sequential=cfg_sequential,
            )

    latents_np = latents.float().cpu().numpy()
    if decode_latents_only:
        return GenerateResult(video_path=None, latents=latents_np, phase_seconds=times)

    video_paths: List[Optional[Path]] = [None] * num_videos
    if output_path is not None:
        output_path = Path(output_path)
        video_paths = [output_path] if num_videos == 1 else [
            output_path.with_name(f"{output_path.stem}_{i}{output_path.suffix}") for i in range(num_videos)]
    out_h, out_w = (height, width) if crop is None else crop[2:]
    decoded = []
    with _phase(times, "vae_decode", device):
        for i, path in enumerate(video_paths):
            writer = None if path is None else media.VideoWriter(path, out_w, out_h, fps, encoder=video_encoder)

            def on_ready(frames: np.ndarray, start: int) -> None:
                u8 = media.frames_to_uint8(frames)[: num_frames - start]
                if crop is not None:
                    top, left, h, w = crop
                    u8 = u8[:, top : top + h, left : left + w]
                writer.write(u8)

            try:
                decoded.append(decode_latents(models, latents[i : i + 1], tiling_config, decode_timestep=0.05,
                                              generator=generators[i],
                                              on_frames_ready=None if writer is None else on_ready))
            finally:
                if writer is not None:
                    writer.close()
    video = decoded[0] if num_videos == 1 else np.concatenate(decoded, axis=0)
    return GenerateResult(video_path=video_paths[0], latents=latents_np, video=video, phase_seconds=times,
                          video_paths=video_paths if num_videos > 1 and output_path is not None else None)
