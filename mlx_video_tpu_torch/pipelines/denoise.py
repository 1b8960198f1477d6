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

The three quality/speed dials (video only, one at a time, each refused
with audio, with sequential CFG and with ``progress_callback``, as in the
JAX function):
- ``teacache_threshold`` > 0 (TeaCache): the relative L1 change of block
  0's adaLN-modulated input (:func:`_tc_signal`) accumulates over the steps;
  a step whose sum stays under the threshold reuses the previous velocity and
  runs no forward, and a full step resets the sum. Step 0 of each call is
  full.
- ``cfg_cache_interval`` k > 1 (with CFG): every k-th step runs the doubled
  CFG forward and keeps the guidance delta v_pos - v_neg in fp32; the other
  steps run one batch-B forward and reuse it.
- ``attn_broadcast_interval`` k > 1 (PAB): a step with ``step % k == 0``
  runs fully and keeps every block's self-attention output
  (models/ltx/model.py), the others reuse them.
Where the JAX scan chooses with ``lax.cond`` and computes both branches'
shapes, this loop decides per step in Python and skips the cached work for
real; it makes the same full/cached decisions (TeaCache reads its sum back
from the device each step to decide).

Progress: ``progress_callback(step, total)`` after each step; without it,
when :func:`utils.profiling.progress_echo_enabled` (an event sink, or
``MLX_VIDEO_UI_JSON``/``MLX_VIDEO_PROGRESS_ECHO``) a ``denoise_step`` event
after each step, the step ended by a device synchronise so its time is
true. Without either the loop adds no synchronise.

The parallel forwards (parallel/): ``sequence_parallel=(mesh, "fsdp")``
runs every DiT forward with its tokens cut over ``fsdp`` and ring
self-attention; ``pipeline_parallel=(mesh, "pipe", num_microbatches[,
data_axis])`` runs it GPipe over a staged model
(parallel/pipeline.py:apply_from_tuple), audio and video streams alike. A
model sharded by parallel/sharding.py runs its rank-local forward on its
own. Every rank gets the whole velocities, so every rank takes the same
steps.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mlx_video_tpu_torch.config import LTXModelConfig
from mlx_video_tpu_torch.models.ltx import rope as rope_lib
from mlx_video_tpu_torch.models.ltx.model import LTXModel, Modality, adaln_apply, ltx_apply, to_denoised
from mlx_video_tpu_torch.ops.linear import linear
from mlx_video_tpu_torch.ops.norms import rms_norm
from mlx_video_tpu_torch.pipelines.conditioning import LatentState, apply_denoise_mask
from mlx_video_tpu_torch.utils import profiling


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


def _make_apply(pp, sp):
    """``ltx_apply``, or the GPipe forward for ``pp``; either with ``sp``."""
    if pp is None:
        def apply(model, config, video, audio, pab=None):
            kw = {k: v for k, v in (("pab", pab), ("sp", sp)) if v is not None}
            return ltx_apply(model, config, video, audio, **kw)

        return apply
    from mlx_video_tpu_torch.parallel.pipeline import apply_from_tuple

    return apply_from_tuple(pp)


def _tc_signal(model: LTXModel, config: LTXModelConfig, v_tokens: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """TeaCache's change signal, (B, S, D) fp32: block 0's adaLN-modulated
    self-attention input (the patchify projection, the adaLN MLP at the
    step's timesteps, block 0's scale-shift table, the RMS norm); a sharded
    model's tensors gathered whole for it."""
    video, block0 = model.video, model.blocks[0]
    specs = getattr(model, "shard_specs", None)
    if specs is not None:
        from mlx_video_tpu_torch.parallel.sharding import gather

        video = gather(video, specs, model.mesh, prefix="video.")
        block0 = gather(block0, specs, model.mesh, prefix="blocks.0.", recurse=False)
    x = linear(video.patchify_proj, v_tokens)
    mod, _ = adaln_apply(video.adaln_single, (ts * config.timestep_scale_multiplier).reshape(-1), x.dtype)
    b, s_t, d = ts.shape[0], ts.shape[1], x.shape[-1]
    mod = mod.reshape(b, s_t, 6, d).float()
    tab0 = block0.scale_shift_table.float()
    shift = tab0[0][None, None, :] + mod[:, :, 0, :]
    scale = tab0[1][None, None, :] + mod[:, :, 1, :]
    return rms_norm(x, eps=config.norm_eps).float() * (1.0 + scale) + shift


class _TeaCache:
    """TeaCache's state over one denoise call: the previous change signal,
    the accumulated relative change (fp32 on the device) and the last full
    step's velocity (fp32)."""

    def __init__(self, threshold: float):
        self.threshold = torch.tensor(threshold, dtype=torch.float32)
        self.prev = self.accum = self.velocity = None

    def full(self, signal: torch.Tensor) -> bool:
        """Whether this step runs the forward: the first step always, then
        once the accumulated change reaches the threshold (which resets it)."""
        full = self.prev is None
        if not full:
            accum = self.accum + (signal - self.prev).abs().mean() / (self.prev.abs().mean() + 1e-8)
            full = bool(accum >= self.threshold)  # the step's one read-back
        self.accum = torch.zeros((), dtype=torch.float32, device=signal.device) if full else accum
        self.prev = signal
        return full


def _cfg_cached_velocity(apply, model: LTXModel, config: LTXModelConfig, bundle, tokens, ts, cfg_scale: float,
                         full: bool, delta: Optional[torch.Tensor]):
    """The CFG cache's guided velocity and its fp32 guidance delta: a full
    step runs the doubled forward and keeps v_pos - v_neg, a cached one
    runs the positive half alone and reuses ``delta``."""
    if full:
        v_pos, v_neg = apply(model, config, _step_inputs(bundle, tokens, ts, "", True, False), None)[0].chunk(2)
        delta = v_pos.float() - v_neg.float()
    else:
        v_pos = apply(model, config, _modality(bundle, tokens, ts, half=0), None)[0]
    return (v_pos.float() + (cfg_scale - 1.0) * delta).to(v_pos.dtype), delta


def _check_dials(use_cfg: bool, cfg_sequential: bool, audio: bool, progress: bool, cfg_cache_interval: int,
                 attn_broadcast_interval: int, teacache_threshold: float, parallel: bool = False) -> None:
    """The JAX function's refusals of the dials' combinations (``parallel``:
    sequence or pipeline parallelism asked for)."""
    if cfg_sequential and use_cfg and (cfg_cache_interval > 1 or attn_broadcast_interval > 1
                                       or teacache_threshold > 0.0):
        raise ValueError(
            "cfg_sequential cannot be combined with cfg_cache_interval, attn_broadcast_interval, or "
            "teacache_threshold (the caching dials assume the batched-CFG forward shape)"
        )
    if teacache_threshold > 0.0:
        if audio:
            raise ValueError("teacache_threshold supports the video-only path")
        if cfg_cache_interval > 1 or attn_broadcast_interval > 1:
            raise ValueError("teacache_threshold cannot be combined with cfg_cache_interval or "
                             "attn_broadcast_interval (one caching dial at a time)")
        if parallel:
            raise ValueError("teacache_threshold does not compose with pipeline/sequence parallelism "
                             "(data-dependent lax.cond around shard_map bodies)")
        if progress:
            raise ValueError("teacache_threshold is a scan-mode feature; per-step progress_callback is "
                             "unsupported with it")
    if attn_broadcast_interval > 1:
        if audio:
            raise ValueError("attn_broadcast_interval supports the video-only path")
        if cfg_cache_interval > 1:
            raise ValueError("attn_broadcast_interval and cfg_cache_interval cannot be combined (their forward "
                             "batch shapes conflict inside the scan)")
        if parallel:
            raise ValueError("attn_broadcast_interval does not compose with pipeline/sequence parallelism "
                             "(data-dependent lax.cond around shard_map bodies)")
        if progress:
            raise ValueError("attn_broadcast_interval is a scan-mode feature; per-step progress_callback is "
                             "unsupported with it")
    if cfg_cache_interval > 1:
        if audio:
            raise ValueError("cfg_cache_interval requires video-only CFG (no joint audio)")
        if progress:
            raise ValueError("cfg_cache_interval is a scan-mode feature; per-step progress_callback is "
                             "unsupported with it")


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
    progress_callback: Optional[Callable[[int, int], None]] = None,
    cfg_cache_interval: int = 1,
    attn_broadcast_interval: int = 1,
    teacache_threshold: float = 0.0,
    full_steps: Optional[List[int]] = None,
    sequence_parallel=None,
    pipeline_parallel=None,
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

    The dials (``teacache_threshold``, ``cfg_cache_interval``,
    ``attn_broadcast_interval``) are described in the module docstring;
    ``full_steps``, when given, receives the indices of the steps a dial ran
    fully. ``progress_callback(step, total)`` is called after each step.
    ``sequence_parallel`` and ``pipeline_parallel`` are described in the
    module docstring; they exclude each other.
    """
    use_cfg = cfg_scale != 1.0 and neg_context is not None
    seq_cfg = use_cfg and cfg_sequential
    _check_dials(use_cfg, cfg_sequential, audio_latents is not None, progress_callback is not None,
                 cfg_cache_interval, attn_broadcast_interval, teacache_threshold,
                 sequence_parallel is not None or pipeline_parallel is not None)
    if pipeline_parallel is not None:
        if sequence_parallel is not None:
            raise ValueError("pipeline_parallel and sequence_parallel are mutually exclusive")
        b_ref = latents.shape[0] if latents is not None else audio_latents.shape[0]
        if b_ref % int(pipeline_parallel[2]) != 0:
            raise ValueError(f"batch={b_ref} not divisible by pipeline num_microbatches={pipeline_parallel[2]}")
    apply = _make_apply(pipeline_parallel, sequence_parallel)
    teacache = _TeaCache(teacache_threshold) if teacache_threshold > 0.0 else None
    cfg_caching = use_cfg and cfg_cache_interval > 1
    pab_k = attn_broadcast_interval
    interval = cfg_cache_interval if cfg_caching else pab_k
    if state is not None:
        latents = state.latent
    if audio_latents is not None and (audio_positions is None or audio_context is None):
        raise ValueError("audio_positions/audio_context must be provided with audio_latents")
    events = progress_callback is None and profiling.progress_echo_enabled()
    sig = [float(s) for s in np.asarray(sigmas, dtype=np.float32)]
    total = len(sig) - 1
    bundle = _make_bundle(config, latents, positions, context, state, use_cfg, neg_context,
                          audio_latents, audio_positions, audio_context, audio_neg_context)
    v_delta = pab_cache = None
    for step, (sigma, sigma_next) in enumerate(zip(sig[:-1], sig[1:])):
        v_tokens = v_ts = a_tokens = a_ts = None
        if latents is not None:
            v_tokens, v_ts = flatten_video_latents(latents), (sigma * bundle["v_mask"]).to(latents.dtype)
        if audio_latents is not None:
            a_tokens = flatten_audio_latents(audio_latents)
            a_ts = (sigma * bundle["a_mask"]).to(audio_latents.dtype)
        full = step % interval == 0
        if teacache is not None:
            full = teacache.full(_tc_signal(model, config, v_tokens, v_ts))
        if full and (teacache is not None or interval > 1) and full_steps is not None:
            full_steps.append(step)
        a_vel = None
        if teacache is not None and not full:
            v_vel = teacache.velocity
        elif cfg_caching:
            v_vel, v_delta = _cfg_cached_velocity(apply, model, config, bundle, v_tokens, v_ts, cfg_scale, full,
                                                  v_delta)
        else:
            video_in = _step_inputs(bundle, v_tokens, v_ts, "", use_cfg, seq_cfg)
            audio_in = _step_inputs(bundle, a_tokens, a_ts, "a_", use_cfg, seq_cfg)
            if pab_k > 1 and full:
                v_vel, a_vel, pab_cache = apply(model, config, video_in, None, pab="collect")
            elif pab_k > 1:
                v_vel, a_vel = apply(model, config, video_in, None, pab=pab_cache)
            elif seq_cfg:
                (v_pos, a_pos), (v_neg, a_neg) = (apply(model, config, video_in[i], audio_in[i]) for i in (0, 1))
            else:
                v_vel, a_vel = apply(model, config, video_in, audio_in)
            if seq_cfg:
                v_vel, a_vel = _guided(v_pos, v_neg, cfg_scale), _guided(a_pos, a_neg, cfg_scale)
            elif use_cfg:
                v_vel, a_vel = _split_guided(v_vel, cfg_scale), _split_guided(a_vel, cfg_scale)
            if teacache is not None:
                teacache.velocity = v_vel.float()
        if latents is not None:
            denoised = to_denoised(latents, unflatten_video_latents(v_vel, latents.shape), sigma)
            if state is not None:
                denoised = apply_denoise_mask(denoised, bundle["clean_latent"], bundle["denoise_mask"])
            latents = _euler_step(latents, denoised, sigma, sigma_next)
        if audio_latents is not None:
            a_denoised = to_denoised(audio_latents, unflatten_audio_latents(a_vel, audio_latents.shape), sigma)
            audio_latents = _euler_step(audio_latents, a_denoised, sigma, sigma_next)
        if progress_callback is not None:
            progress_callback(step + 1, total)
        elif events:
            probe = latents if latents is not None else audio_latents
            if probe.device.type == "cuda":
                torch.cuda.synchronize(probe.device)
            profiling.step_event(step + 1, total, sigma=sigma)
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
    sequence_parallel=None,
    pipeline_parallel=None,
) -> torch.Tensor:
    """The audio alone through an AudioOnly (or AudioVideo) model; CFG when
    ``audio_neg_context`` is given and ``cfg_scale != 1``. Returns the audio
    latents. A sharded model runs its rank-local forward; a staged one
    needs ``pipeline_parallel`` (as :func:`denoise`)."""
    use_cfg = cfg_scale != 1.0 and audio_neg_context is not None
    return denoise(
        model, config, None, None, None, sigmas, neg_context=audio_neg_context if use_cfg else None,
        cfg_scale=cfg_scale, audio_latents=audio_latents,
        audio_positions=audio_positions, audio_context=audio_context, audio_neg_context=audio_neg_context,
        sequence_parallel=sequence_parallel, pipeline_parallel=pipeline_parallel,
    )[1]
