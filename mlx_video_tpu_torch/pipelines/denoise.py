"""Denoising loop (video-only), distilled or with classifier-free guidance, as
a plain Python loop.

Counterpart of the video-only branches of mlx_video_tpu/pipelines/denoise.py:
denoise. Each step runs the DiT on the flattened latents, forms the denoised
estimate x0 = x_t - sigma * v, blends the conditioning state's clean latent
back in where its denoise mask says so, and takes an fp32 Euler step; the
last step (sigma_next = 0) reduces to x0.

With ``neg_context`` and ``cfg_scale != 1`` the step is guided:
v = v_pos + (cfg_scale - 1) * (v_pos - v_neg). Batched CFG (the default) runs
one forward over the doubled batch (context and negative context stacked,
latents, timesteps, positions and RoPE tables doubled); sequential CFG
(``cfg_sequential``) runs two forwards of batch B, one on each half.

Not ported yet: audio, the TeaCache, PAB and cfg-cache dials and the parallel
forwards.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

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


def _make_bundle(
    config: LTXModelConfig,
    latents: torch.Tensor,
    positions: torch.Tensor,
    context: torch.Tensor,
    state: Optional[LatentState],
    use_cfg: bool,
    neg_context: Optional[torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """The loop-constant tensors: timestep mask, contexts, positions and RoPE
    tables (doubled for CFG, once per denoise call), conditioning state."""
    bundle = {"v_mask": video_timesteps_mask(state, latents.shape, latents.dtype, latents.device)}
    pe = precompute_video_pe(config, positions)
    if use_cfg:
        bundle["context"] = torch.cat([context, neg_context], dim=0)
        bundle["positions"] = _double(positions)
        bundle["pe_cos"], bundle["pe_sin"] = _double(pe[0]), _double(pe[1])
    else:
        bundle["context"], bundle["positions"] = context, positions
        bundle["pe_cos"], bundle["pe_sin"] = pe
    if state is not None:
        bundle["clean_latent"] = state.clean_latent
        bundle["denoise_mask"] = state.denoise_mask
    return bundle


def _modality(bundle: Dict[str, torch.Tensor], tokens: torch.Tensor, ts: torch.Tensor, half=None) -> Modality:
    """The DiT's input from the bundle, or from the ``half``-th half of its
    doubled tensors (sequential CFG)."""
    pick = (lambda x: x) if half is None else (lambda x: _half(x, half))
    return Modality(
        latent=tokens, timesteps=ts, context=pick(bundle["context"]), positions=pick(bundle["positions"]),
        pe=(pick(bundle["pe_cos"]), pick(bundle["pe_sin"])),
    )


def denoise(
    model: LTXModel,
    config: LTXModelConfig,
    latents: torch.Tensor,
    positions: torch.Tensor,
    context: torch.Tensor,
    sigmas: Sequence[float],
    neg_context: Optional[torch.Tensor] = None,
    cfg_scale: float = 1.0,
    state: Optional[LatentState] = None,
    cfg_sequential: bool = False,
) -> torch.Tensor:
    """Run the sigma schedule over (B, C, F, H, W) latents.

    ``positions`` is the (B, 3, F*H*W, 2) pixel-space grid; ``context`` (and
    ``neg_context``) the (B, S_ctx, caption_channels) text embeddings. CFG is
    on when ``neg_context`` is given and ``cfg_scale != 1``. With ``state``
    the loop starts from ``state.latent``, every token gets its frame's
    timestep (sigma times the denoise mask) and each step's estimate is
    blended with the clean latent. Returns the final latents.
    """
    use_cfg = cfg_scale != 1.0 and neg_context is not None
    seq_cfg = use_cfg and cfg_sequential
    if state is not None:
        latents = state.latent
    sig = [float(s) for s in np.asarray(sigmas, dtype=np.float32)]
    bundle = _make_bundle(config, latents, positions, context, state, use_cfg, neg_context)
    shape = latents.shape
    for sigma, sigma_next in zip(sig[:-1], sig[1:]):
        tokens = flatten_video_latents(latents)
        ts = (sigma * bundle["v_mask"]).to(latents.dtype)
        if seq_cfg:
            pos, neg = (ltx_apply(model, config, _modality(bundle, tokens, ts, half=i)) for i in (0, 1))
            velocity = _cfg_combine(pos, neg, cfg_scale)
        elif use_cfg:
            pos, neg = ltx_apply(model, config, _modality(bundle, _double(tokens), _double(ts))).chunk(2, dim=0)
            velocity = _cfg_combine(pos, neg, cfg_scale)
        else:
            velocity = ltx_apply(model, config, _modality(bundle, tokens, ts))
        denoised = to_denoised(latents, unflatten_video_latents(velocity, shape), sigma)
        if state is not None:
            denoised = apply_denoise_mask(denoised, bundle["clean_latent"], bundle["denoise_mask"])
        latents = _euler_step(latents, denoised, sigma, sigma_next)
    return latents
