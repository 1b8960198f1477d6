"""Video generation: the distilled two-stage pipeline (stage-1 denoise at half
size, 2x latent upsample, renoise, stage-2 refine, VAE decode) with its
keyframe and IC-LoRA forms, and the dev pipeline (single stage,
classifier-free guidance over the ``ltx2_scheduler`` schedule, VAE decode);
each with or without synchronized audio.

Counterpart of mlx_video_tpu/pipelines/generate.py:generate_video, with ``decode_latents``,
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
Audio (``audio``): ``joint`` denoises (B, 8, T, 16) audio latents with the
video in one AudioVideo transformer (the dev pipeline's default; stage 2
renoises them as it renoises the video), ``separate`` denoises them after the
video with ``ModelBundle.audio_transformer``, an AudioOnly model, over
``audio_steps`` of the stage-1 schedule (the distilled pipelines' default;
CFG when negative audio embeddings exist). Both then decode them to a
waveform (audio VAE decoder, HiFi-GAN vocoder), write a 16-bit WAV and mux it
into the mp4 with ffmpeg; without ffmpeg the silent video is the output, as
in the JAX function.
The quality/speed dials (pipelines/denoise.py) pass to every video
denoise: ``attn_broadcast_interval`` and ``teacache_threshold`` at both
distilled stages and in the dev pipeline, ``cfg_cache_interval`` in the dev
pipeline; each is refused with joint audio. ``GenerateResult.full_steps``
holds, per denoise phase, the steps a dial ran fully.

Events (utils/profiling.py): a ``phase`` event as each phase ends, the
denoise loop's ``denoise_step`` events, and while the decode hands frames
on, ``progress`` events and, every ``MLX_VIDEO_PREVIEW_EVERY`` (12) frames,
a preview: the latest frame as a PIL JPEG (quality 85, at most
``MLX_VIDEO_PREVIEW_MAX_DIM`` (512) pixels a side), written atomically to
``MLX_VIDEO_PREVIEW_PATH`` and sent base64 in a ``preview`` event when a
sink subscribes. A run with no sink, no ``MLX_VIDEO_UI_JSON`` and no
preview path hands no frames on beyond the writer's.

Sharded generation (parallel/): ``mesh`` (a (data, fsdp, tensor)
``DeviceMesh``) runs every DiT forward rank-local on the bundle's
transformers (stage 1, stage 2 and the AudioOnly one) sharded over it
(loading.py:shard_models; done here for a transformer not sharded yet,
replacing it in the bundle), with ``sequence_parallel`` the video tokens
cut over ``fsdp`` and ring self-attention (the separate audio denoise takes
no ring, as in JAX); ``pipeline_parallel`` P > 0 runs it GPipe over P
stages of a (data, pipe[, fsdp, tensor]) mesh built here
(``pipeline_tensor`` TP ways inside each stage), the bundle's transformers
replaced by this rank's stage. Every rank draws the same noise from the
same seeds and gets the whole velocities of every step, so every rank holds
the same latents. Under ``mesh`` the upsample and the video decode are
mesh-resident, as in JAX: the upsampler and the decoder stay whole on every
rank (JAX replicates them, ``replicate_params``), each rank runs them on its
rows of H (sharding.py:shard_spatial, JAX's ``spatial_sharding`` rule) with
halo rows exchanged at every conv, and the rows are gathered after each
stage (the upsampled latents before stage 2, each decoded tile's frames).
The audio decode and the conditioning encoder run whole on every rank, as
in JAX, and only the primary rank (rank 0) writes files.

The single-device memory plan (``low_memory``, the JAX function's
choreography of host staging): the VAE decoder, the upsampler and the
audio decoder and vocoder are parked off the card at the start (on the
host in pinned memory; with ``aux_int8_staging`` as per-group int8,
io/staging.py, and with ``aux_park_device`` too as int8 on the card); the
VAE encoder comes in for the conditioning encode and goes out after it;
the upsampler's copies are issued before stage 1 and those of the decoder
and the audio stacks at the upsample, on a side stream while the card
denoises (``overlap_staging``; without it each comes in, after a fence,
when its phase starts); after the last denoise every transformer is
dropped from the bundle (``keep_transformer`` keeps them) and the cache
allocator's free blocks go back to the card (``torch.cuda.empty_cache``)
before the decoder and the audio stacks come in for the decode; with
``keep_transformer`` everything is parked again at the end, so the next
run starts parked. A run without ``low_memory`` on a bundle that such a run
left parked first brings its modules back. The fence between the moves is
``utils/device.py:drain_device_queue``.

Randomness: video i draws all its noise from its own ``torch.Generator``
(the one given, or one seeded with ``seed + i`` or ``seeds[i]`` on the
model's device), in this order: distilled, the stage-1 noise (with
conditionings, inside the mask-scaled renoise of the conditioned state),
[joint audio: the audio noise], the stage-2 renoise (with image
conditionings, the masked renoise of the stage-2 state), [joint audio: the
stage-2 audio renoise], [separate audio: the audio noise] and the decode
noise; dev, the initial noise (masked by the conditioning state), [joint
audio: the audio noise], [separate audio: the audio noise] and the decode
noise. The bracketed draws exist only with audio, so a run without audio
draws what it drew before audio was ported. The order is the same with and
without conditionings, and a batch of N videos draws exactly the noise of N
single runs. (The JAX function splits one key into 8 and takes keys 0, 1
and 2 for the three video draws, keys 5 and 6 for the joint audio noise and
its stage-2 renoise and key 7 for the separate audio noise.)

Differences from the JAX function, on purpose:
- The video is decoded whether or not ``output_path`` is given; the mp4 is
  written only when it is.
- Decodes read back fp32 (the JAX function reads fp16 on an accelerator). A
  tiled decode of CUDA latents blends on the card
  (tiling.decode_with_tiling_device); on the CPU it blends on the host.
- The decode noise is drawn once for the whole latents and mixed in before
  tiling, so a streamed (tiled) decode sees the noise of an untiled one
  (the JAX decoder draws each tile's noise from the same key).
- The waveform is decoded whether or not a path is given
  (``GenerateResult.audio``); the WAV is written when ``output_path`` or
  ``output_audio_path`` is given. Its decode runs in fp32 on the latents, as
  the JAX function decodes the fp32 host copy of its latents.
"""

from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mlx_video_tpu_torch.config import LTXModelConfig, VideoVAEConfig
from mlx_video_tpu_torch.io import media, staging
from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import AudioDecoder, AudioVAEConfig
from mlx_video_tpu_torch.models.ltx.audio_vae.processing import save_wav
from mlx_video_tpu_torch.models.ltx.audio_vae.vocoder import Vocoder, VocoderConfig, decode_audio
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
from mlx_video_tpu_torch.parallel.distributed import is_primary_host
from mlx_video_tpu_torch.pipelines import denoise as dn
from mlx_video_tpu_torch.pipelines.conditioning import (
    LatentState,
    VideoCondition,
    VideoConditionByKeyframeIndex,
    VideoConditionByLatentIndex,
    add_noise_with_state,
    apply_conditioning,
)
from mlx_video_tpu_torch.pipelines.positions import (
    AUDIO_LATENT_CHANNELS,
    AUDIO_MEL_BINS,
    compute_audio_frames,
    create_audio_position_grid,
    create_position_grid,
)
from mlx_video_tpu_torch.pipelines.schedulers import (
    STAGE_1_SIGMAS,
    STAGE_2_SIGMAS,
    ltx2_scheduler,
    subsample_refinement_sigmas,
    subsample_sigmas,
)
from mlx_video_tpu_torch.utils import profiling
from mlx_video_tpu_torch.utils.device import drain_device_queue

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
    when given, refines stage 2 in place of ``transformer``. Audio needs the
    audio decoder and vocoder, joint audio an AudioVideo ``transformer`` and
    separate audio an AudioOnly ``audio_transformer``. Under ``low_memory``
    a module may be an io/staging.py ``ParkedModule`` between its phases,
    and the transformers are ``None`` after such a run."""

    transformer: LTXModel
    transformer_config: LTXModelConfig
    vae_decoder: VideoDecoder
    vae_decoder_config: DecoderConfig
    upsampler: Optional[LatentUpsampler] = None
    vae_encoder: Optional[VideoEncoder] = None
    vae_encoder_config: Optional[VideoVAEConfig] = None
    stage2_transformer: Optional[LTXModel] = None
    audio_decoder: Optional[AudioDecoder] = None
    audio_decoder_config: Optional[AudioVAEConfig] = None
    vocoder: Optional[Vocoder] = None
    vocoder_config: Optional[VocoderConfig] = None
    audio_transformer: Optional[LTXModel] = None
    audio_transformer_config: Optional[LTXModelConfig] = None

    @property
    def latents_mean(self) -> torch.Tensor:
        return _decoder_tensor(self.vae_decoder, "latents_mean")

    @property
    def latents_std(self) -> torch.Tensor:
        return _decoder_tensor(self.vae_decoder, "latents_std")


def _decoder_tensor(decoder, name: str) -> torch.Tensor:
    """The decoder's latent statistic, from its park while it is parked."""
    return decoder.tensor(name) if isinstance(decoder, staging.ParkedModule) else getattr(decoder, name)


@dataclass
class TextConditioning:
    """Precomputed text context."""

    video_embeddings: torch.Tensor  # (B, S_ctx, caption_channels)
    video_neg_embeddings: Optional[torch.Tensor] = None  # the negative prompt, for CFG
    audio_embeddings: Optional[torch.Tensor] = None  # (B, S_ctx, audio_caption_channels)
    audio_neg_embeddings: Optional[torch.Tensor] = None


@dataclass
class GenerateResult:
    video_path: Optional[Path]
    latents: np.ndarray
    video: Optional[np.ndarray] = None  # (N, 3, F, H, W) fp32 in [-1, 1]
    phase_seconds: Dict[str, float] = field(default_factory=dict)
    video_paths: Optional[List[Path]] = None  # num_videos > 1: {stem}_{i}{suffix}, one a video
    audio_latents: Optional[np.ndarray] = None  # (1, 8, T, 16) fp32
    audio: Optional[np.ndarray] = None  # (2, 240 * (4T - 3)) fp32 waveform in [-1, 1]
    audio_path: Optional[Path] = None  # the WAV
    full_steps: Dict[str, List[int]] = field(default_factory=dict)  # with a dial: phase -> steps run fully


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
    mesh=None,
) -> np.ndarray:
    """Tiled (or whole) VAE decode -> (B, 3, F, H, W) fp32 numpy in [-1, 1].

    ``generator`` draws the decode noise (none without it), once for the
    whole latents, so the tiling and a mesh leave it unchanged. A tiled
    decode runs one decoder call per tile and blends on the card for CUDA
    latents (tiling.decode_with_tiling_device), on the host otherwise
    (tiling.decode_with_tiling). ``on_frames_ready(frames, start)`` receives
    each finalised frame range (the whole video when untiled). ``mesh``:
    each decoder call runs on this rank's rows of its input
    (:func:`_on_rows`) and every rank gets the whole frames.
    """
    dec_cfg = models.vae_decoder_config
    device = latents.device
    timestep = None
    if decode_timestep is not None:
        timestep = torch.full((latents.shape[0],), decode_timestep, dtype=torch.float32, device=device)
    latents = add_decode_noise(dec_cfg, latents, generator=generator)

    def decode(x: torch.Tensor) -> torch.Tensor:
        return _on_rows(lambda part, rows, ts: video_decoder_apply(models.vae_decoder, dec_cfg, part, timestep=ts,
                                                                   rows=rows), x, mesh, timestep)

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
    for model in (models.transformer, models.stage2_transformer, models.audio_transformer):
        head = None if model is None else (model.video if hasattr(model, "video") else model.audio)
        got = None if head is None else head.scale_shift_table.dtype
        if got is not None and got != dtype:
            raise ValueError(
                f"transformer params are {got} but the pipeline dtype is {dtype}; "
                f"build the weights in the pipeline dtype or pass dtype={got}"
            )


class _Previews:
    """The decode's preview JPEGs (see the module docstring): one encode a
    preview feeds the file and the sinks."""

    def __init__(self):
        self.path = os.environ.get("MLX_VIDEO_PREVIEW_PATH")
        self.every = int(os.environ.get("MLX_VIDEO_PREVIEW_EVERY", "12"))
        self.max_dim = int(os.environ.get("MLX_VIDEO_PREVIEW_MAX_DIM", "512"))
        self.reset()

    def reset(self) -> None:
        """Frame indices restart at 0 with each video."""
        self.last = -self.every

    def wanted(self) -> bool:
        return self.path is not None or profiling.has_event_sinks()

    def __call__(self, frame_u8: np.ndarray, idx: int) -> None:
        stream = profiling.has_event_sinks()
        if (self.path is None and not stream) or idx - self.last < self.every:
            return
        import base64
        import io

        from PIL import Image

        img = Image.fromarray(frame_u8)
        if self.max_dim > 0:
            img.thumbnail((self.max_dim, self.max_dim))
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=85)
        jpeg = buf.getvalue()
        if self.path is not None:
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(jpeg)
            os.replace(tmp, self.path)
        if stream:
            profiling.ui_event({"kind": "preview", "frame": int(idx), "jpeg_b64": base64.b64encode(jpeg).decode()})
        self.last = idx


def _dial_refusal(joint_audio: bool, cfg_cache_interval: int, attn_broadcast_interval: int,
                  teacache_threshold: float) -> None:
    if joint_audio and (cfg_cache_interval > 1 or attn_broadcast_interval > 1 or teacache_threshold > 0.0):
        raise ValueError(
            "the caching dials (cfg_cache_interval, attn_broadcast_interval, teacache_threshold) support the "
            "video-only path; drop the dial or generate audio separately (audio_mode=separate)"
        )


def _on_rows(stage: Callable, x: torch.Tensor, mesh, batched: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``stage(part, rows, batched_part)`` on this rank's rows (and batch)
    of the video tensor ``x`` under ``mesh`` (parallel/sharding.py:
    spatial_spec; ``rows`` the group its H is cut over, ``batched_part`` this
    rank's rows of ``batched``, a per-video tensor), the parts gathered
    whole; ``stage(x, None, batched)`` without a mesh."""
    if mesh is None:
        return stage(x, None, batched)
    from mlx_video_tpu_torch.parallel import sharding

    spec = sharding.spatial_spec(mesh, x.shape)
    part = sharding.shard_spatial(x, mesh)
    if batched is not None and spec[0] is not None:
        batched = sharding.local_slice(batched, spec[:1], sharding.mesh_groups(mesh), "batch")
    return sharding.gather_spatial(stage(part, sharding.spatial_group(mesh, spec), batched), mesh, spec)


def _parallel_setup(models: ModelBundle, mesh, sequence_parallel: bool, pipeline_parallel: int,
                    pipeline_microbatches: int, pipeline_data: int, pipeline_tensor: int,
                    attn_broadcast_interval: int):
    """The JAX function's checks of the parallel options; shards (or stages)
    the bundle's transformers, the audio one too, in place (loading.py);
    returns denoise's (sp, pp). The conv stacks stay whole on every rank,
    where JAX calls ``replicate_params`` on them."""
    from mlx_video_tpu_torch.loading import shard_models, stage_models

    sp = (mesh, "fsdp") if (sequence_parallel and mesh is not None) else None
    if not pipeline_parallel:
        if mesh is not None:
            shard_models(models, mesh)
        return sp, None
    if mesh is not None or sequence_parallel:
        raise ValueError("pipeline_parallel is mutually exclusive with mesh/sequence_parallel")
    if attn_broadcast_interval > 1:
        raise ValueError("attn_broadcast_interval does not compose with pipeline_parallel")
    if pipeline_microbatches > 1 or pipeline_data > 1:
        raise ValueError(
            "generate_video runs a latent batch of 1; pipeline_microbatches/pipeline_data have nothing to split "
            "— use pipeline_parallel stages (+ pipeline_tensor) for inference, and the trainer config for "
            "microbatched pipelines"
        )
    pp_mesh = stage_models(models, pipeline_parallel, data=pipeline_data, tensor=pipeline_tensor)
    return None, (pp_mesh, "pipe", pipeline_microbatches, "data" if pipeline_data > 1 else None)


_AUX = ("vae_decoder", "vae_encoder", "upsampler", "audio_decoder", "vocoder")


class _Staging:
    """The moves of the memory plan (the JAX function's ``_stage``,
    ``_prefetch`` and ``_stage_in``); each is the module itself without
    ``low_memory``. Parks go to ``park_device``: the card with
    ``aux_park_device`` and the int8 codec, else the host."""

    def __init__(self, models: ModelBundle, device: torch.device, low_memory: bool, int8: bool,
                 park_device: torch.device, overlap: bool):
        self.models, self.device, self.low_memory, self.int8 = models, device, low_memory, int8
        self.park_device, self.overlap = park_device, overlap
        self.handles: dict = {}

    def out(self, module):
        """Park ``module`` (a fence first), its codes computed on the card."""
        if not self.low_memory or module is None:
            return module
        drain_device_queue(self.device)
        return staging.park(module, self.park_device, quantize=self.int8, work=self.device)

    def into(self, module):
        """``module`` on the card (a fence first), dequantized if it has codes."""
        if not self.low_memory or module is None:
            return module
        drain_device_queue(self.device)
        return staging.unpark_int8(module, self.device)

    def prefetch(self, attr: str) -> None:
        """Issue the copies of the bundle's parked ``attr`` while the card is
        busy (no fence); :meth:`stage_in` takes them."""
        if not self.overlap or attr in self.handles or getattr(self.models, attr) is None:
            return
        self.handles[attr] = staging.unpark_begin(getattr(self.models, attr), self.device)

    def stage_in(self, attr: str):
        """The bundle's ``attr`` on the card: the prefetch's, or :meth:`into`."""
        handle = self.handles.pop(attr, None)
        if handle is not None:
            return staging.unpark_finish(handle)
        return self.into(getattr(self.models, attr))


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
    prompt: str = "",
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
    cfg_cache_interval: int = 1,
    attn_broadcast_interval: int = 1,
    teacache_threshold: float = 0.0,
    optimize_layouts: bool = False,
    progress_callback: Optional[Callable[[int, int], None]] = None,
    images: Sequence[Tuple[str, int, float]] = (),
    video_conditionings: Sequence[Tuple[str, int, float]] = (),
    output_path: Optional[Union[str, Path]] = None,
    tiling: str = "auto",
    stream: bool = False,
    decode_latents_only: bool = False,
    dtype=torch.bfloat16,
    video_encoder: str = "ffmpeg",
    audio: bool = False,
    audio_mode: str = "auto",
    audio_steps: int = 8,
    audio_filter: Optional[str] = None,
    audio_bitrate: str = "256k",
    output_audio_path: Optional[Union[str, Path]] = None,
    profile: bool = False,
    mem_log: bool = False,
    mesh=None,
    sequence_parallel: bool = False,
    pipeline_parallel: int = 0,
    pipeline_microbatches: int = 1,
    pipeline_data: int = 1,
    pipeline_tensor: int = 1,
    low_memory: bool = False,
    aux_int8_staging: bool = False,
    overlap_staging: Optional[bool] = None,
    aux_park_device: Optional[bool] = None,
    keep_transformer: bool = False,
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

    ``audio`` adds synchronized audio: ``audio_mode`` "joint" (an
    AudioVideo ``models.transformer`` denoises it with the video), "separate"
    (``models.audio_transformer`` denoises it after the video, ``audio_steps``
    steps) or "auto" (joint for dev, separate otherwise). The waveform goes to
    ``output_audio_path`` (default: the output path with ``.wav``) and is
    muxed into the mp4 (``audio_filter``, an ffmpeg -af chain, and
    ``audio_bitrate``) when ffmpeg exists. One video only.

    The dials ``attn_broadcast_interval``, ``teacache_threshold`` and (dev)
    ``cfg_cache_interval`` trade quality for speed in each video denoise
    (pipelines/denoise.py; not with joint audio). ``progress_callback(step,
    total)`` is called after every video denoise step.

    Phase seconds (``GenerateResult.phase_seconds``) end with a device
    synchronise; ``profile`` prints the phase report before returning, and
    ``profile`` or ``mem_log`` prints the device memory line at "stage1
    complete" and "stage2 complete" (distilled) or "denoise complete" (dev).

    ``mesh``, ``sequence_parallel``, ``pipeline_parallel`` (with
    ``pipeline_microbatches``, ``pipeline_data`` and ``pipeline_tensor``):
    sharded generation, in the module docstring.

    ``low_memory``: the single-device memory plan of the module docstring;
    the bundle's transformers are ``None`` afterwards (reload them before
    reuse) unless ``keep_transformer``. ``aux_int8_staging``: park as
    per-group int8 (needs ``low_memory``). ``aux_park_device``: with the
    codec, park on the card (default: ``MLX_VIDEO_AUX_PARK=device``).
    ``overlap_staging``: copy the parked modules in on a side stream while
    the card denoises (default on; ``MLX_VIDEO_OVERLAP_STAGING=0`` turns it
    off; never under ``pipeline_parallel``). ``prompt`` is taken, as the
    JAX function takes it, and not read; ``optimize_layouts`` (XLA's layout
    pre-placement) has nothing to do here: the weights are in the layouts
    the kernels read.
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
    joint_audio = separate_audio = False
    if audio:
        if audio_mode == "auto":
            audio_mode = "separate" if pipeline != PipelineType.DEV else "joint"
        if audio_mode not in ("joint", "separate"):
            raise ValueError("audio_mode must be 'auto', 'joint' or 'separate'")
        joint_audio, separate_audio = audio_mode == "joint", audio_mode == "separate"
        if joint_audio and not models.transformer_config.model_type.audio_enabled:
            raise ValueError("Joint audio requires an AudioVideo transformer config")
        if num_videos > 1:
            raise ValueError("num_videos > 1 does not compose with audio yet")
    _dial_refusal(joint_audio, cfg_cache_interval, attn_broadcast_interval, teacache_threshold)
    if low_memory and mesh is not None:
        raise ValueError(
            "low_memory and mesh are mutually exclusive: with >= 2 devices the upsampler/decoder stay mesh-resident "
            "(replicated params, H-sharded activations) and host staging is not needed"
        )
    if aux_int8_staging and not low_memory:
        raise ValueError(
            "aux_int8_staging is a low_memory transfer codec (int8 on the host<->HBM wire); it has no effect without "
            "low_memory — pass low_memory=True or drop the flag"
        )
    if models.transformer is None:
        raise ValueError("the bundle has no transformer: a low_memory run frees it; load the bundle again")
    sp, pp = _parallel_setup(models, mesh, sequence_parallel, pipeline_parallel, pipeline_microbatches,
                             pipeline_data, pipeline_tensor, attn_broadcast_interval)
    parallel = dict(sequence_parallel=sp, pipeline_parallel=pp)
    if not is_primary_host():
        output_path = output_audio_path = None  # the primary rank writes the files
    device = models.transformer.video.scale_shift_table.device
    if aux_park_device is None:
        aux_park_device = os.environ.get("MLX_VIDEO_AUX_PARK", "host") == "device"
    if overlap_staging is None:
        overlap_staging = os.environ.get("MLX_VIDEO_OVERLAP_STAGING", "1") != "0"
    plan = _Staging(models, device, low_memory, aux_int8_staging,
                    device if aux_park_device and aux_int8_staging else torch.device("cpu"),
                    low_memory and overlap_staging and pp is None)
    if low_memory:
        for attr in ("vae_decoder", "upsampler", "audio_decoder", "vocoder"):
            setattr(models, attr, plan.out(getattr(models, attr)))
    else:  # a bundle that a low_memory run left parked (or a loader left on the host) comes back whole
        for attr in _AUX:
            setattr(models, attr, staging.unpark_int8(getattr(models, attr), device))
    vid_seeds = [int(s) for s in seeds] if seeds is not None else [seed + i for i in range(num_videos)]
    generators = [generator] if generator is not None else [
        torch.Generator(device=device).manual_seed(s) for s in vid_seeds]
    timer = profiling.PhaseTimer(device)
    full_steps: Dict[str, List[int]] = {}
    dials = dict(attn_broadcast_interval=attn_broadcast_interval, teacache_threshold=teacache_threshold,
                 progress_callback=progress_callback)

    def steps_of(phase: str) -> List[int]:
        return full_steps.setdefault(phase, [])

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

    audio_frames = compute_audio_frames(num_frames, fps) if audio else 0
    audio_shape = (1, AUDIO_LATENT_CHANNELS, audio_frames, AUDIO_MEL_BINS)
    audio_positions = (torch.from_numpy(create_audio_position_grid(1, audio_frames)).to(device)
                       if audio else None)

    def audio_embeddings(name: str) -> Optional[torch.Tensor]:
        emb = getattr(text, name)
        return None if emb is None else emb.to(device=device, dtype=dtype)

    joint = {}  # the audio arguments of a joint denoise

    def joint_audio_args(latents_a: torch.Tensor) -> dict:
        return dict(audio_latents=latents_a, audio_positions=audio_positions,
                    audio_context=audio_embeddings("audio_embeddings"),
                    audio_neg_context=audio_embeddings("audio_neg_embeddings"))

    if dev:
        conds = []
        if images:
            models.vae_encoder = plan.into(models.vae_encoder)
            with timer.phase("cond_encode"):
                conds = _encode_conditionings(models, images, height, width, num_frames, dtype)
            models.vae_encoder = plan.out(models.vae_encoder)
        sigmas = ltx2_scheduler(steps=num_inference_steps, num_tokens=latent_frames * latent_h * latent_w)
        shape = (num_videos, latent_channels, latent_frames, latent_h, latent_w)
        state = _conditioned_state(zeros(shape), conds, noise, float(sigmas[0])) if conds else None
        latents = noise(shape) if state is None else state.latent
        if joint_audio:
            joint = joint_audio_args(noise(audio_shape))
        with timer.phase("dev_denoise"):
            latents, audio_latents = dn.denoise(
                models.transformer, config, latents, positions(latent_h, latent_w), context, sigmas,
                neg_context=neg, cfg_scale=cfg_scale, state=state, cfg_sequential=cfg_sequential, **joint,
                cfg_cache_interval=cfg_cache_interval, full_steps=steps_of("dev_denoise"), **dials, **parallel,
            )
        profiling.log_memory("denoise complete", profile or mem_log, device=device)
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
            models.vae_encoder = plan.into(models.vae_encoder)
            with timer.phase("cond_encode"):
                s1_conds = _encode_conditionings(models, images, height // 2, width // 2, num_frames, dtype,
                                                 videos=video_conditionings, mode=conditioning_mode)
                s2_conds = _encode_conditionings(models, images, height, width, num_frames, dtype,
                                                 mode=conditioning_mode)
            models.vae_encoder = plan.out(models.vae_encoder)  # done for good: off the card before the denoise

        plan.prefetch("upsampler")  # its copies ride under stage 1
        with timer.phase("stage1_denoise"):
            shape1 = (num_videos, latent_channels, latent_frames, latent_h // 2, latent_w // 2)
            state1 = _conditioned_state(zeros(shape1), s1_conds, noise, s1_sigmas[0]) if s1_conds else None
            latents = noise(shape1) if state1 is None else state1.latent
            if joint_audio:
                joint = joint_audio_args(noise(audio_shape))
            latents, audio_latents = dn.denoise(
                models.transformer, config, latents, positions(latent_h // 2, latent_w // 2), context, s1_sigmas,
                state=state1, **joint, full_steps=steps_of("stage1_denoise"), **dials, **parallel,
            )
        profiling.log_memory("stage1 complete", profile or mem_log, device=device)

        if not decode_latents_only:  # their copies ride under the upsample and stage 2
            plan.prefetch("vae_decoder")
            if models.audio_decoder is not None:
                plan.prefetch("audio_decoder")
                plan.prefetch("vocoder")
        with timer.phase("upsample"):
            upsampler = plan.stage_in("upsampler")  # the bundle keeps the park
            mean, std = models.latents_mean.to(device), models.latents_std.to(device)
            latents = _on_rows(lambda part, rows, _: upsample_latents(upsampler, part, mean, std, rows), latents,
                               mesh)
            del upsampler

        with timer.phase("stage2_denoise"):
            sigma0 = s2_sigmas[0]
            state2 = _conditioned_state(latents, s2_conds, noise, sigma0) if s2_conds else None
            latents = noise(latents.shape) * sigma0 + latents * (1.0 - sigma0) if state2 is None else state2.latent
            if joint_audio:
                joint["audio_latents"] = noise(audio_latents.shape) * sigma0 + audio_latents * (1.0 - sigma0)
                if stage2_cfg and neg is not None and joint["audio_neg_context"] is None:
                    raise ValueError("stage2_cfg with joint audio requires audio_neg_embeddings "
                                     "(the negative-prompt audio context) in TextConditioning.")
            stage2 = models.stage2_transformer if models.stage2_transformer is not None else models.transformer
            latents, audio_latents = dn.denoise(
                stage2, config, latents, positions(latent_h, latent_w), context, s2_sigmas,
                neg_context=neg if stage2_cfg else None, cfg_scale=cfg_scale, state=state2,
                cfg_sequential=cfg_sequential, **joint, full_steps=steps_of("stage2_denoise"), **dials,
                **parallel,
            )
        profiling.log_memory("stage2 complete", profile or mem_log, device=device)

    if separate_audio:
        if models.audio_transformer is None:
            raise ValueError("Separate audio requires an AudioOnly transformer")
        a_context, a_neg = audio_embeddings("audio_embeddings"), audio_embeddings("audio_neg_embeddings")
        if a_context is None:
            raise ValueError("Separate audio requires audio text embeddings")
        a_init = noise(audio_shape)
        with timer.phase("audio_denoise"):
            audio_latents = dn.denoise_audio_only(
                models.audio_transformer, models.audio_transformer_config or config, a_init, audio_positions,
                a_context, subsample_sigmas(STAGE_1_SIGMAS, audio_steps, "farthest"), audio_neg_context=a_neg,
                cfg_scale=cfg_scale if a_neg is not None else 1.0, pipeline_parallel=pp,
            )

    if not (cfg_cache_interval > 1 or attn_broadcast_interval > 1 or teacache_threshold > 0.0):
        full_steps = {}
    if not decode_latents_only:
        plan.prefetch("vae_decoder")
        if audio and models.audio_decoder is not None:
            plan.prefetch("audio_decoder")
            plan.prefetch("vocoder")
    latents_np = latents.float().cpu().numpy()
    audio_np = audio_latents.float().cpu().numpy() if audio else None
    if low_memory:
        if not keep_transformer:  # every reference goes, and the allocator gives the blocks back
            models.transformer = models.stage2_transformer = models.audio_transformer = None
            stage2 = None  # noqa: F841
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        if not decode_latents_only:
            models.vae_decoder = plan.stage_in("vae_decoder")
            if models.audio_decoder is not None:
                models.audio_decoder = plan.stage_in("audio_decoder")
                models.vocoder = plan.stage_in("vocoder")
    if decode_latents_only:
        if profile:
            timer.report()
        return GenerateResult(video_path=None, latents=latents_np, phase_seconds=timer.phases,
                              audio_latents=audio_np, full_steps=full_steps)

    video_paths: List[Optional[Path]] = [None] * num_videos
    if output_path is not None:
        output_path = Path(output_path)
        video_paths = [output_path] if num_videos == 1 else [
            output_path.with_name(f"{output_path.stem}_{i}{output_path.suffix}") for i in range(num_videos)]
        if audio:  # the silent video, until the audio is muxed in
            video_paths = [output_path.with_suffix(".temp.mp4")]
    out_h, out_w = (height, width) if crop is None else crop[2:]
    decoded = []
    previews = _Previews()
    # frames go on beyond the writer only when someone reads the events or previews
    hand_on = previews.wanted() or os.environ.get("MLX_VIDEO_UI_JSON") == "1"
    with timer.phase("vae_decode"):
        for i, path in enumerate(video_paths):
            writer = None if path is None else media.VideoWriter(path, out_w, out_h, fps, encoder=video_encoder)
            previews.reset()
            t0, done = time.perf_counter(), [0]

            def on_ready(frames: np.ndarray, start: int) -> None:
                u8 = media.frames_to_uint8(frames)[: num_frames - start]
                if crop is not None:
                    top, left, h, w = crop
                    u8 = u8[:, top : top + h, left : left + w]
                if writer is not None:
                    writer.write(u8)
                previews(u8[-1], start + u8.shape[0] - 1)
                done[0] += u8.shape[0]
                profiling.ui_event({
                    "kind": "progress", "phase": "decode", "current": done[0], "total": num_frames, "video": i,
                    "eta_seconds": (time.perf_counter() - t0) / max(done[0], 1) * max(num_frames - done[0], 0),
                })

            try:
                decoded.append(decode_latents(models, latents[i : i + 1], tiling_config, decode_timestep=0.05,
                                              generator=generators[i],
                                              on_frames_ready=on_ready if writer is not None or hand_on else None,
                                              mesh=mesh))
            finally:
                if writer is not None:
                    writer.close()
    video = decoded[0] if num_videos == 1 else np.concatenate(decoded, axis=0)
    result = GenerateResult(video_path=video_paths[0], latents=latents_np, video=video, phase_seconds=timer.phases,
                            video_paths=video_paths if num_videos > 1 and output_path is not None else None,
                            audio_latents=audio_np, full_steps=full_steps)
    if audio and models.audio_decoder is not None:
        _decode_and_mux_audio(models, audio_latents, result, output_path, output_audio_path, audio_filter,
                              audio_bitrate, timer)
    elif audio and output_path is not None:
        video_paths[0].rename(output_path)  # audio asked for, none decoded: the video still lands there
        result.video_path = output_path
    if low_memory and keep_transformer:  # the next run starts parked
        for attr in ("vae_decoder", "upsampler", "audio_decoder", "vocoder"):
            setattr(models, attr, plan.out(getattr(models, attr)))
    if profile:
        timer.report()
    return result


def _decode_and_mux_audio(models: ModelBundle, audio_latents: torch.Tensor, result: GenerateResult,
                          output_path: Optional[Path], output_audio_path, audio_filter: Optional[str],
                          audio_bitrate: str, timer: profiling.PhaseTimer) -> None:
    """The ``audio_decode`` phase (latents -> fp32 waveform, the WAV) and,
    with an mp4, the ``audio_mux`` phase: ffmpeg muxes the WAV into the
    silent video at ``result.video_path``, or without ffmpeg that video
    becomes the output. Fills ``result``'s audio fields."""
    rate = models.vocoder_config.output_sample_rate
    with timer.phase("audio_decode"):
        wav = decode_audio(audio_latents.float(), models.audio_decoder, models.audio_decoder_config,
                           models.vocoder, models.vocoder_config)
        result.audio = wav.cpu().numpy()
        wav_path = Path(output_audio_path) if output_audio_path else (
            None if output_path is None else output_path.with_suffix(".wav"))
        if wav_path is not None:
            save_wav(str(wav_path), result.audio, rate)
            result.audio_path = wav_path
    if output_path is None:
        return
    silent = result.video_path
    with timer.phase("audio_mux"):
        if media.mux_audio(silent, wav_path, output_path, audio_filter=audio_filter, audio_bitrate=audio_bitrate,
                           audio_sample_rate=rate):
            silent.unlink(missing_ok=True)
        else:
            silent.rename(output_path)
    result.video_path = output_path
