"""Training strategies: text-to-video and video-to-video (IC-LoRA).

Counterpart of mlx_video_tpu/trainer/strategies.py:
- flow matching x_t = (1 - sigma) x + sigma eps, target v = eps - x;
- first-frame conditioning with probability p: conditioned tokens keep the
  clean latent, timestep 0, and are excluded from the loss;
- V2V / IC-LoRA: clean reference latents are prepended on the sequence axis
  with their own position grid, always conditioned, loss-masked;
- loss = token-masked mean of the channel-summed squared error.

``prepare_*`` builds the batch's tensors on the device from the host
arrays. The JAX ``make_inputs`` is split in two: :func:`draw_inputs` takes
(sigmas, noise, keep) from a ``torch.Generator``, and :func:`make_inputs`
applies given draws, so the same draws can go through both packages.

Audio-video training: the audio latents (B, T, C*M) are noised with the
video's sigma, carry it as every token's timestep, have no first-frame
conditioning and share the video's caption mask; their loss term is added
to the video's. The audio noise is the last draw of a step (after sigmas,
keep and the video noise), so a video-only step draws exactly what it drew
before audio existed; the JAX package splits a fourth key for it instead.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mlx_video_tpu_torch.config import LTXModelConfig
from mlx_video_tpu_torch.models.ltx.model import LTXModel, Modality, ltx_apply
from mlx_video_tpu_torch.pipelines.positions import create_audio_position_grid, create_position_grid
from mlx_video_tpu_torch.pipelines.schedulers import BASE_SHIFT_ANCHOR, MAX_SHIFT_ANCHOR

DEFAULT_FPS = 24.0


class StrategyBatch(NamedTuple):
    """Static-shaped tensors cut from a dataset Batch."""

    video_latents: torch.Tensor  # (B, S, C) patchified clean latents, fp32
    positions: torch.Tensor  # (B, 3, S, 2)
    context: torch.Tensor  # (B, S_ctx, D_ctx)
    context_mask: Optional[torch.Tensor]  # (B, S_ctx)
    first_frame_token_mask: torch.Tensor  # (B, S) bool: tokens of frame 0
    always_conditioned_mask: torch.Tensor  # (B, S) bool: V2V reference tokens
    audio_latents: Optional[torch.Tensor] = None  # (B, T, C*M) fp32
    audio_positions: Optional[torch.Tensor] = None  # (B, 1, T, 2)
    audio_context: Optional[torch.Tensor] = None  # (B, S_ctx, D_ctx)


class Draws(NamedTuple):
    """The random numbers of one step."""

    sigmas: torch.Tensor  # (B,) fp32
    noise: torch.Tensor  # (B, S, C) fp32
    keep: torch.Tensor  # (B, 1) bool: first-frame conditioning on for the sample
    audio_noise: Optional[torch.Tensor] = None  # (B, T, C*M) fp32


class ModelInputs(NamedTuple):
    video: Modality
    video_targets: torch.Tensor  # fp32
    video_loss_mask: torch.Tensor  # (B, S) bool
    audio: Optional[Modality] = None
    audio_targets: Optional[torch.Tensor] = None  # fp32
    audio_loss_mask: Optional[torch.Tensor] = None  # (B, T) bool


def patchify_video_latents(latents: np.ndarray) -> np.ndarray:
    """(B, C, F, H, W) -> (B, F*H*W, C)."""
    while latents.ndim > 5 and latents.shape[1] == 1:
        latents = latents.squeeze(1)
    b, c, f, h, w = latents.shape
    return np.transpose(latents, (0, 2, 3, 4, 1)).reshape(b, f * h * w, c)


def patchify_audio_latents(latents: np.ndarray) -> np.ndarray:
    """(B, C, T, M) -> (B, T, C*M)."""
    while latents.ndim > 4 and latents.shape[1] == 1:
        latents = latents.squeeze(1)
    b, c, t, m = latents.shape
    return np.transpose(latents, (0, 2, 1, 3)).reshape(b, t, c * m)


def _dims(lat: Dict[str, Any]) -> Tuple[int, int, int, float]:
    f = int(np.asarray(lat["num_frames"]).reshape(-1)[0])
    h = int(np.asarray(lat["height"]).reshape(-1)[0])
    w = int(np.asarray(lat["width"]).reshape(-1)[0])
    fps = float(np.asarray(lat.get("fps", [DEFAULT_FPS])).reshape(-1)[0])
    return f, h, w, fps


def _context(cond: Dict[str, Any]) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    embeds = cond.get("video_prompt_embeds", cond.get("prompt_embeds"))
    if embeds is None:
        raise ValueError("Missing prompt embeddings in conditions")
    embeds = np.asarray(embeds, dtype=np.float32)
    if embeds.ndim == 2:
        embeds = embeds[None]
    mask = cond.get("prompt_attention_mask")
    if mask is not None:
        mask = np.asarray(mask)
        if mask.ndim == 1:
            mask = mask[None]
    return embeds, mask


def _first_frame_token_mask(b: int, f: int, h: int, w: int) -> np.ndarray:
    mask = np.zeros((b, f, h, w), dtype=bool)
    mask[:, 0] = True
    return mask.reshape(b, f * h * w)


def _on(device, **arrays) -> Dict[str, Optional[torch.Tensor]]:
    return {k: None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device) for k, a in arrays.items()}


def prepare_text_to_video(batch, with_audio: bool = False, device="cpu") -> StrategyBatch:
    """The T2V strategy's tensors on ``device``; with ``with_audio`` and audio
    latents in the batch also the audio stream's (its context the
    ``audio_prompt_embeds``, else the video's)."""
    lat = batch.latents
    f, h, w, fps = _dims(lat)
    video = patchify_video_latents(np.asarray(lat["latents"], dtype=np.float32))
    b = video.shape[0]
    context, context_mask = _context(batch.conditions)
    audio = {}
    if with_audio and batch.audio_latents is not None:
        audio_lat = patchify_audio_latents(np.asarray(batch.audio_latents["latents"], np.float32))
        a_embeds = batch.conditions.get("audio_prompt_embeds")
        audio_ctx = np.asarray(a_embeds if a_embeds is not None else context, dtype=np.float32)
        audio = dict(audio_latents=audio_lat, audio_positions=create_audio_position_grid(b, audio_lat.shape[1]),
                     audio_context=audio_ctx[None] if audio_ctx.ndim == 2 else audio_ctx)
    return StrategyBatch(**_on(
        device,
        video_latents=video,
        positions=create_position_grid(b, f, h, w, fps=fps),
        context=context,
        context_mask=context_mask,
        first_frame_token_mask=_first_frame_token_mask(b, f, h, w),
        always_conditioned_mask=np.zeros((b, video.shape[1]), dtype=bool),
        **audio,
    ))


def prepare_video_to_video(batch, device="cpu") -> StrategyBatch:
    """V2V / IC-LoRA: reference latents prepended on the token axis."""
    lat, ref = batch.latents, batch.ref_latents
    if ref is None:
        raise ValueError("video_to_video strategy requires reference_latents")
    f, h, w, fps = _dims(lat)
    rf, rh, rw, _ = _dims(ref)
    target = patchify_video_latents(np.asarray(lat["latents"], np.float32))
    reference = patchify_video_latents(np.asarray(ref["latents"], np.float32))
    b = target.shape[0]
    ref_seq_len = reference.shape[1]
    context, context_mask = _context(batch.conditions)
    positions = np.concatenate(
        [create_position_grid(b, rf, rh, rw, fps=fps), create_position_grid(b, f, h, w, fps=fps)], axis=2
    )
    return StrategyBatch(**_on(
        device,
        video_latents=np.concatenate([reference, target], axis=1),
        positions=positions,
        context=context,
        context_mask=context_mask,
        first_frame_token_mask=np.concatenate(
            [np.zeros((b, ref_seq_len), dtype=bool), _first_frame_token_mask(b, f, h, w)], axis=1
        ),
        always_conditioned_mask=np.concatenate(
            [np.ones((b, ref_seq_len), dtype=bool), np.zeros((b, target.shape[1]), dtype=bool)], axis=1
        ),
    ))


def sample_sigmas(
    generator: torch.Generator, batch: int, seq_len: int, mode: str = "uniform", std: float = 1.0
) -> torch.Tensor:
    """Timestep samplers (B,) fp32 on the generator's device."""
    if mode == "shifted_logit_normal":
        m = (2.05 - 0.95) / (MAX_SHIFT_ANCHOR - BASE_SHIFT_ANCHOR)
        shift = m * seq_len + (0.95 - m * BASE_SHIFT_ANCHOR)
        normal = torch.randn((batch,), generator=generator, device=generator.device)
        return torch.sigmoid(normal * std + shift)
    return torch.rand((batch,), generator=generator, device=generator.device)


def draw_inputs(
    sb: StrategyBatch,
    generator: torch.Generator,
    first_frame_conditioning_p: float = 0.1,
    timestep_sampling_mode: str = "uniform",
    timestep_sampling_std: float = 1.0,
) -> Draws:
    """One step's draws, in this order from ``generator``: sigmas, keep,
    noise, then the audio noise when the batch has audio; returned on the
    batch's device."""
    b, s, _ = sb.video_latents.shape
    sigmas = sample_sigmas(generator, b, s, timestep_sampling_mode, timestep_sampling_std)
    keep = torch.rand((b, 1), generator=generator, device=generator.device) < first_frame_conditioning_p
    noise = torch.randn(sb.video_latents.shape, generator=generator, device=generator.device)
    audio_noise = None
    if sb.audio_latents is not None:
        audio_noise = torch.randn(sb.audio_latents.shape, generator=generator, device=generator.device)
    device = sb.video_latents.device
    return Draws(sigmas=sigmas.to(device), noise=noise.to(device), keep=keep.to(device),
                 audio_noise=None if audio_noise is None else audio_noise.to(device))


def make_inputs(sb: StrategyBatch, draws: Draws, dtype=torch.float32) -> ModelInputs:
    """Noise the latents with the given draws and build the model input in
    ``dtype`` (the model's): conditioned tokens (reference tokens, and the
    first frame where ``keep``) keep the clean latent, get timestep 0 and are
    loss-masked. The audio tokens (when the batch has them) take the
    video's sigma and are all in the loss. Targets stay fp32."""
    video = sb.video_latents
    b, s, _ = video.shape
    cond_mask = (sb.first_frame_token_mask & draws.keep) | sb.always_conditioned_mask
    sig = draws.sigmas[:, None, None]
    noisy = (1.0 - sig) * video + sig * draws.noise
    noisy = torch.where(cond_mask[..., None], video, noisy)
    targets = torch.where(cond_mask[..., None], torch.zeros_like(video), draws.noise - video)
    timesteps = torch.where(cond_mask, torch.zeros((), device=video.device), draws.sigmas[:, None].expand(b, s))
    audio = {}
    if sb.audio_latents is not None:
        a = sb.audio_latents
        ab, at, _ = a.shape
        a_noisy = (1.0 - sig) * a + sig * draws.audio_noise
        audio = dict(
            audio=Modality(
                latent=a_noisy.to(dtype),
                timesteps=draws.sigmas[:, None].expand(ab, at).to(dtype),
                context=sb.audio_context.to(dtype),
                context_mask=sb.context_mask,
                positions=sb.audio_positions,
            ),
            audio_targets=draws.audio_noise - a,
            audio_loss_mask=torch.ones((ab, at), dtype=torch.bool, device=a.device),
        )
    return ModelInputs(
        **audio,
        video=Modality(
            latent=noisy.to(dtype),
            timesteps=timesteps.to(dtype),
            context=sb.context.to(dtype),
            context_mask=sb.context_mask,
            positions=sb.positions,
        ),
        video_targets=targets,
        video_loss_mask=~cond_mask,
    )


def _masked_mean_sq(pred: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    v = torch.sum(torch.square(pred.float() - targets), dim=-1)
    v = torch.where(mask, v, torch.zeros((), device=v.device))
    return v.sum() / mask.sum().clamp(min=1)


def compute_loss(video_pred: torch.Tensor, inputs: ModelInputs, audio_pred: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token-masked mean of the channel-summed squared error, fp32; plus the
    audio stream's, when there is one."""
    loss = _masked_mean_sq(video_pred, inputs.video_targets, inputs.video_loss_mask)
    if audio_pred is not None and inputs.audio_targets is not None:
        loss = loss + _masked_mean_sq(audio_pred, inputs.audio_targets, inputs.audio_loss_mask)
    return loss


def strategy_loss_fn(
    model: LTXModel,
    config: LTXModelConfig,
    sb: StrategyBatch,
    draws: Draws,
) -> torch.Tensor:
    """Inputs from the draws -> model forward (video, and audio when the
    batch has it) -> masked MSE. The model input is cast to the model's
    dtype (its output table's)."""
    inputs = make_inputs(sb, draws, dtype=model.video.scale_shift_table.dtype)
    video_pred, audio_pred = ltx_apply(model, config, inputs.video, inputs.audio)
    return compute_loss(video_pred, inputs, audio_pred)
