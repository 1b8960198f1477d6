"""Denoising loops, distilled or with classifier-free guidance, as plain
Python loops: video, joint audio-video, and audio only.

Counterpart of mlx_video_tpu/pipelines/denoise.py: denoise and
denoise_audio_only. Each step runs the DiT on the flattened latents, forms the denoised
estimate x0 = x_t - sigma * v, blends the conditioning state's clean latent
back in where its denoise mask says so, and takes an fp32 Euler step; the
last step (sigma_next = 0) reduces to x0.

With ``neg_context`` and ``cfg_scale != 1`` the step is guided:
v = v_pos + (cfg_scale - 1) * (v_pos - v_neg). Batched CFG (the default) runs
one forward over the doubled batch (context and negative context stacked,
latents, timesteps, positions and RoPE tables doubled); sequential CFG
(``cfg_sequential``) runs two forwards of batch B, one on each half.

Audio latents (B, C, T, M) go through the DiT as (B, T, C*M) tokens that
share one sigma (a (B, 1) timestep mask: audio has no conditioning); with
video they are denoised jointly by an AudioVideo model over the same
schedule, each modality taking its own CFG combine and Euler step.

Not ported yet: the TeaCache, PAB and cfg-cache dials and the parallel
forwards.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mlx_video_tpu_torch.config import LTXModelConfig
from mlx_video_tpu_torch.models.ltx import rope as rope_lib
from mlx_video_tpu_torch.models.ltx.model import LTXModel, Modality, ltx_apply, to_denoised
from mlx_video_tpu_torch.pipelines.conditioning import LatentState, apply_denoise_mask


def flatten_video_latents(latents: torch.Tensor) -> torch.Tensor:
    """(B, C, F, H, W) -> (B, F*H*W, C) token layout."""
    b, c = latents.shape[0], latents.shape[1]
    return latents.reshape(b, c, -1).transpose(1, 2)


def unflatten_video_latents(tokens: torch.Tensor, shape) -> torch.Tensor:
    """(B, S, C) -> (B, C, F, H, W)."""
    b, c, f, h, w = shape
    return tokens.transpose(1, 2).reshape(b, c, f, h, w)


def flatten_audio_latents(latents: torch.Tensor) -> torch.Tensor:
    """(B, C, T, M) -> (B, T, C*M)."""
    b, c, t, m = latents.shape
    return latents.permute(0, 2, 1, 3).reshape(b, t, c * m)


def unflatten_audio_latents(tokens: torch.Tensor, shape) -> torch.Tensor:
    """(B, T, C*M) -> (B, C, T, M)."""
    b, c, t, m = shape
    return tokens.reshape(b, t, c, m).permute(0, 2, 1, 3)


def video_timesteps_mask(state: Optional[LatentState], shape, dtype, device=None) -> torch.Tensor:
    """Per-token denoise mask (B, F*H*W) from the per-frame state. With no
    state every token shares one sigma, so the mask is (B, 1) ones and the
    adaLN modulation stays per batch row."""
    b, _, f, h, w = shape
    if state is None:
        return torch.ones((b, 1), dtype=dtype, device=device)
    mask = state.denoise_mask.reshape(b, 1, f, 1, 1).expand(b, 1, f, h, w)
    return mask.reshape(b, f * h * w).to(dtype)


def precompute_video_pe(config: LTXModelConfig, positions: torch.Tensor):
    return rope_lib.precompute_freqs_cis(
        positions,
        dim=config.inner_dim,
        theta=config.positional_embedding_theta,
        max_pos=config.positional_embedding_max_pos,
        use_middle_indices_grid=config.use_middle_indices_grid,
        num_attention_heads=config.num_attention_heads,
        rope_type=config.rope_type,
        double_precision=config.double_precision_rope,
    )


def precompute_audio_pe(config: LTXModelConfig, positions: torch.Tensor):
    return rope_lib.precompute_freqs_cis(
        positions,
        dim=config.audio_inner_dim,
        theta=config.positional_embedding_theta,
        max_pos=config.audio_positional_embedding_max_pos,
        use_middle_indices_grid=config.use_middle_indices_grid,
        num_attention_heads=config.audio_num_attention_heads,
        rope_type=config.rope_type,
        double_precision=config.double_precision_rope,
    )


def _euler_step(latents: torch.Tensor, denoised: torch.Tensor, sigma: float, sigma_next: float) -> torch.Tensor:
    """fp32 Euler update; exact at sigma_next = 0."""
    lat = latents.float()
    den = denoised.float()
    return (den + sigma_next * (lat - den) / sigma).to(latents.dtype)


def _cfg_combine(pos: torch.Tensor, neg: torch.Tensor, scale: float) -> torch.Tensor:
    """v = v_pos + (scale - 1)(v_pos - v_neg)."""
    return pos + (scale - 1.0) * (pos - neg)


def _double(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (2B, ...)."""
    return torch.cat([x, x], dim=0)


def _half(x: torch.Tensor, i: int) -> torch.Tensor:
    """(2B, ...) -> the i-th (B, ...) half (inverse of the CFG doubling)."""
    return x.chunk(2, dim=0)[i]


def _put_context(bundle: Dict[str, torch.Tensor], prefix: str, context, neg_context, positions, pe,
                 use_cfg: bool) -> None:
    """A modality's contexts, positions and RoPE tables, doubled for CFG."""
    if use_cfg:
        bundle[prefix + "context"] = torch.cat([context, neg_context], dim=0)
        bundle[prefix + "positions"] = _double(positions)
        bundle[prefix + "pe_cos"], bundle[prefix + "pe_sin"] = _double(pe[0]), _double(pe[1])
    else:
        bundle[prefix + "context"], bundle[prefix + "positions"] = context, positions
        bundle[prefix + "pe_cos"], bundle[prefix + "pe_sin"] = pe


def _make_bundle(
    config: LTXModelConfig,
    latents: Optional[torch.Tensor],
    positions: Optional[torch.Tensor],
    context: Optional[torch.Tensor],
    state: Optional[LatentState],
    use_cfg: bool,
    neg_context: Optional[torch.Tensor],
    audio_latents: Optional[torch.Tensor] = None,
    audio_positions: Optional[torch.Tensor] = None,
    audio_context: Optional[torch.Tensor] = None,
    audio_neg_context: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """The loop-constant tensors: timestep masks, contexts, positions and
    RoPE tables (doubled for CFG, once per denoise call), conditioning state;
    the audio entries under ``a_``."""
    bundle = {}
    if latents is not None:
        bundle["v_mask"] = video_timesteps_mask(state, latents.shape, latents.dtype, latents.device)
        _put_context(bundle, "", context, neg_context, positions, precompute_video_pe(config, positions), use_cfg)
        if state is not None:
            bundle["clean_latent"] = state.clean_latent
            bundle["denoise_mask"] = state.denoise_mask
    if audio_latents is not None:
        bundle["a_mask"] = torch.ones((audio_latents.shape[0], 1), dtype=audio_latents.dtype,
                                      device=audio_latents.device)
        _put_context(bundle, "a_", audio_context, audio_neg_context, audio_positions,
                     precompute_audio_pe(config, audio_positions), use_cfg)
    return bundle


def _modality(bundle: Dict[str, torch.Tensor], tokens: torch.Tensor, ts: torch.Tensor, half=None,
              prefix: str = "") -> Modality:
    """The DiT's input from the bundle's ``prefix`` entries, or from the
    ``half``-th half of its doubled tensors (sequential CFG)."""
    pick = (lambda x: x) if half is None else (lambda x: _half(x, half))
    return Modality(
        latent=tokens, timesteps=ts, context=pick(bundle[prefix + "context"]),
        positions=pick(bundle[prefix + "positions"]),
        pe=(pick(bundle[prefix + "pe_cos"]), pick(bundle[prefix + "pe_sin"])),
    )


def _step_inputs(bundle, tokens, ts, prefix: str, use_cfg: bool, seq_cfg: bool):
    """A modality's DiT inputs for one step: one Modality, the doubled one
    for batched CFG, or the two halves for sequential CFG; None without
    ``tokens``."""
    if tokens is None:
        return (None, None) if seq_cfg else None
    if seq_cfg:
        return tuple(_modality(bundle, tokens, ts, half=i, prefix=prefix) for i in (0, 1))
    if use_cfg:
        tokens, ts = _double(tokens), _double(ts)
    return _modality(bundle, tokens, ts, prefix=prefix)


def _guided(pos: Optional[torch.Tensor], neg: Optional[torch.Tensor], cfg_scale: float):
    return None if pos is None else _cfg_combine(pos, neg, cfg_scale)


def _split_guided(vel: Optional[torch.Tensor], cfg_scale: float):
    """The CFG combine of a doubled-batch velocity."""
    return None if vel is None else _cfg_combine(*vel.chunk(2, dim=0), cfg_scale)


def denoise(
    model: LTXModel,
    config: LTXModelConfig,
    latents: Optional[torch.Tensor],
    positions: Optional[torch.Tensor],
    context: Optional[torch.Tensor],
    sigmas: Sequence[float],
    neg_context: Optional[torch.Tensor] = None,
    cfg_scale: float = 1.0,
    state: Optional[LatentState] = None,
    cfg_sequential: bool = False,
    audio_latents: Optional[torch.Tensor] = None,
    audio_positions: Optional[torch.Tensor] = None,
    audio_context: Optional[torch.Tensor] = None,
    audio_neg_context: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Run the sigma schedule over (B, C, F, H, W) latents and, with
    ``audio_latents``, (B, C, T, M) audio latents jointly (an AudioVideo
    model); returns (video latents, audio latents or None).

    ``positions`` is the (B, 3, F*H*W, 2) pixel-space grid; ``context`` (and
    ``neg_context``) the (B, S_ctx, caption_channels) text embeddings; the
    audio has its own ``audio_positions`` (B, 1, T, 2) and contexts. CFG is
    on when ``neg_context`` is given and ``cfg_scale != 1``. With ``state``
    the loop starts from ``state.latent``, every video token gets its
    frame's timestep (sigma times the denoise mask) and each step's video
    estimate is blended with the clean latent. With no video (``latents``
    and ``state`` None) the loop runs the audio alone.
    """
    use_cfg = cfg_scale != 1.0 and neg_context is not None
    seq_cfg = use_cfg and cfg_sequential
    if state is not None:
        latents = state.latent
    if audio_latents is not None and (audio_positions is None or audio_context is None):
        raise ValueError("audio_positions/audio_context must be provided with audio_latents")
    sig = [float(s) for s in np.asarray(sigmas, dtype=np.float32)]
    bundle = _make_bundle(config, latents, positions, context, state, use_cfg, neg_context,
                          audio_latents, audio_positions, audio_context, audio_neg_context)
    for sigma, sigma_next in zip(sig[:-1], sig[1:]):
        v_tokens = v_ts = a_tokens = a_ts = None
        if latents is not None:
            v_tokens, v_ts = flatten_video_latents(latents), (sigma * bundle["v_mask"]).to(latents.dtype)
        if audio_latents is not None:
            a_tokens = flatten_audio_latents(audio_latents)
            a_ts = (sigma * bundle["a_mask"]).to(audio_latents.dtype)
        video_in = _step_inputs(bundle, v_tokens, v_ts, "", use_cfg, seq_cfg)
        audio_in = _step_inputs(bundle, a_tokens, a_ts, "a_", use_cfg, seq_cfg)
        if seq_cfg:
            (v_pos, a_pos), (v_neg, a_neg) = (ltx_apply(model, config, video_in[i], audio_in[i]) for i in (0, 1))
            v_vel, a_vel = _guided(v_pos, v_neg, cfg_scale), _guided(a_pos, a_neg, cfg_scale)
        elif use_cfg:
            v_vel, a_vel = ltx_apply(model, config, video_in, audio_in)
            v_vel, a_vel = _split_guided(v_vel, cfg_scale), _split_guided(a_vel, cfg_scale)
        else:
            v_vel, a_vel = ltx_apply(model, config, video_in, audio_in)
        if latents is not None:
            denoised = to_denoised(latents, unflatten_video_latents(v_vel, latents.shape), sigma)
            if state is not None:
                denoised = apply_denoise_mask(denoised, bundle["clean_latent"], bundle["denoise_mask"])
            latents = _euler_step(latents, denoised, sigma, sigma_next)
        if audio_latents is not None:
            a_denoised = to_denoised(audio_latents, unflatten_audio_latents(a_vel, audio_latents.shape), sigma)
            audio_latents = _euler_step(audio_latents, a_denoised, sigma, sigma_next)
    return latents, audio_latents


def denoise_audio_only(
    model: LTXModel,
    config: LTXModelConfig,
    audio_latents: torch.Tensor,
    audio_positions: torch.Tensor,
    audio_context: torch.Tensor,
    sigmas: Sequence[float],
    audio_neg_context: Optional[torch.Tensor] = None,
    cfg_scale: float = 1.0,
) -> torch.Tensor:
    """The audio alone through an AudioOnly (or AudioVideo) model; CFG when
    ``audio_neg_context`` is given and ``cfg_scale != 1``. Returns the audio
    latents."""
    use_cfg = cfg_scale != 1.0 and audio_neg_context is not None
    return denoise(
        model, config, None, None, None, sigmas, neg_context=audio_neg_context if use_cfg else None,
        cfg_scale=cfg_scale, audio_latents=audio_latents,
        audio_positions=audio_positions, audio_context=audio_context, audio_neg_context=audio_neg_context,
    )[1]
