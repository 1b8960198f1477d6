"""LTX-2 diffusion transformer, video-only, in PyTorch.

Counterpart of mlx_video_tpu/models/ltx/model.py. The modules here hold the
parameters under the JAX pytree's names (``blocks.3.attn1.to_q.weight`` is
``params["blocks"]["attn1"]["to_q"]["weight"][3]``), and the forward is a set
of plain functions with the JAX names that take the modules as their
parameters. The 48 blocks are an ``nn.ModuleList`` run by a Python loop
where the JAX package stacks them and scans.

fp32 islands as in the JAX package: timestep sinusoids, RoPE tables and
rotation, normalisations and the output LayerNorm.

Training: with ``config.gradient_checkpointing`` each block runs under
non-reentrant ``torch.utils.checkpoint`` while gradients are on (the JAX
``jax.checkpoint`` around the scanned block body): the backward recomputes
the block's forward, so one block's activations are held at a time.
Parameters are created with ``requires_grad=False``; a trainer turns on the
ones it trains (lora.py's adapters, or everything in full finetuning).

SPLIT-RoPE self-attention goes to K5 (the rotation inside the flash kernel)
when the fused-RoPE route is on (``MLX_VIDEO_TPU_FUSED_ROPE=1``,
ops/attention.py), as in the JAX ``attention_apply``.

Not ported yet: the audio and audio-video branches, PAB attention caching and
sequence parallelism.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mlx_video_tpu_torch.config import LTXModelConfig, LTXRopeType
from mlx_video_tpu_torch.models.ltx import rope as rope_lib
from mlx_video_tpu_torch.ops.attention import fused_split_rope_eligible, sdpa_flat, sdpa_flat_fused_rope
from mlx_video_tpu_torch.ops.linear import Linear, init_linear_, linear
from mlx_video_tpu_torch.ops.norms import layer_norm, rms_norm


class Modality(NamedTuple):
    """Pipeline -> model interface.

    latent:    (B, S, C) flattened latent tokens
    timesteps: (B, S_t) per-token sigmas, S_t in {1, S}
    context:   (B, S_ctx, caption_channels) text context
    positions: (B, n_dims, S, 2) pixel-space [start, end) bounds, or None when
               ``pe`` is given
    context_mask: optional (B, S_ctx) 0/1 mask (converted to additive bias)
    pe:        optional precomputed (cos, sin) RoPE tables
    """

    latent: torch.Tensor
    timesteps: torch.Tensor
    context: torch.Tensor
    positions: Optional[torch.Tensor] = None
    context_mask: Optional[torch.Tensor] = None
    pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


# ---------------------------------------------------------------------------
# Parameter modules (names follow the JAX pytree)
# ---------------------------------------------------------------------------


def _param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype), requires_grad=False)


class RMSNormWeight(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.weight = _param(dim, device=device, dtype=dtype)


class TimestepEmbedder(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.linear1 = Linear(256, dim, device=device, dtype=dtype)
        self.linear2 = Linear(dim, dim, device=device, dtype=dtype)


class AdaLayerNormSingle(nn.Module):
    def __init__(self, dim: int, coefficient: int = 6, device=None, dtype=None):
        super().__init__()
        self.emb = nn.ModuleDict({"timestep_embedder": TimestepEmbedder(dim, device, dtype)})
        self.linear = Linear(dim, coefficient * dim, device=device, dtype=dtype)


class Attention(nn.Module):
    def __init__(self, query_dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        inner = heads * dim_head
        ctx = query_dim if context_dim is None else context_dim
        kw = dict(device=device, dtype=dtype)
        self.to_q = Linear(query_dim, inner, **kw)
        self.to_k = Linear(ctx, inner, **kw)
        self.to_v = Linear(ctx, inner, **kw)
        self.q_norm = RMSNormWeight(inner, **kw)
        self.k_norm = RMSNormWeight(inner, **kw)
        self.to_out = Linear(inner, query_dim, **kw)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, device=None, dtype=None):
        super().__init__()
        self.proj_in = Linear(dim, dim * mult, device=device, dtype=dtype)
        self.proj_out = Linear(dim * mult, dim, device=device, dtype=dtype)


class TextProjection(nn.Module):
    def __init__(self, in_features: int, hidden: int, device=None, dtype=None):
        super().__init__()
        self.linear1 = Linear(in_features, hidden, device=device, dtype=dtype)
        self.linear2 = Linear(hidden, hidden, device=device, dtype=dtype)


class TransformerBlock(nn.Module):
    """Video branch of one block: self-attention, text cross-attention, FFN."""

    def __init__(self, dim: int, heads: int, d_head: int, context_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn1 = Attention(dim, heads, d_head, **kw)
        self.attn2 = Attention(dim, heads, d_head, context_dim=context_dim, **kw)
        self.ff = FeedForward(dim, **kw)
        self.scale_shift_table = _param(6, dim, **kw)


class VideoParams(nn.Module):
    """Per-modality input/output projections (the JAX ``params["video"]``)."""

    def __init__(self, config: LTXModelConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        dim = config.inner_dim
        self.patchify_proj = Linear(config.in_channels, dim, **kw)
        self.adaln_single = AdaLayerNormSingle(dim, 6, **kw)
        self.caption_projection = TextProjection(config.caption_channels, dim, **kw)
        self.scale_shift_table = _param(2, dim, **kw)
        self.proj_out = Linear(dim, config.out_channels, **kw)


class LTXModel(nn.Module):
    """Video-only LTX-2 DiT parameters; the forward is :func:`ltx_apply`.

    Built on ``device="meta"`` it is a skeleton that holds no memory, for a
    loader to fill with ``load_state_dict(..., assign=True)``; before that,
    ``ops/quant.py:use_quant_linears`` turns the linears a checkpoint holds
    packed into ``QuantLinear``s.
    """

    def __init__(self, config: LTXModelConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        video = config.get_video_config()
        if video is None or config.get_audio_config() is not None:
            raise ValueError("the port runs the VideoOnly model type only")
        self.video = VideoParams(config, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(
            TransformerBlock(video.dim, video.heads, video.d_head, video.context_dim, device, dtype)
            for _ in range(config.num_layers)
        )


def init_ltx_params(
    config: LTXModelConfig,
    generator: torch.Generator,
    device=None,
    dtype=torch.bfloat16,
) -> LTXModel:
    """Build the model and draw its weights on ``device`` from ``generator``:
    linears U(-1/sqrt(in), 1/sqrt(in)) with zero bias, RMSNorm weights one,
    scale-shift tables zero (the init of the JAX ``init_ltx_params``)."""
    if device is None:
        device = generator.device
    model = LTXModel(config, device=device, dtype=dtype)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Linear):
                init_linear_(module, generator)
            elif isinstance(module, RMSNormWeight):
                module.weight.fill_(1.0)
        model.video.scale_shift_table.zero_()
        for block in model.blocks:
            block.scale_shift_table.zero_()
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal embedding of 1D timesteps, fp32."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    if flip_sin_to_cos:
        return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def adaln_apply(
    ada: AdaLayerNormSingle, timestep_flat: torch.Tensor, dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """AdaLayerNormSingle: returns (modulation (N, coeff*dim), embedded (N, dim))."""
    proj = timestep_embedding(timestep_flat, 256).to(dtype)
    te = ada.emb["timestep_embedder"]
    embedded = linear(te.linear2, F.silu(linear(te.linear1, proj)))
    return linear(ada.linear, F.silu(embedded)), embedded


def attention_apply(
    attn: Attention,
    x: torch.Tensor,
    heads: int,
    rope_type: LTXRopeType,
    norm_eps: float = 1e-6,
    context: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """QKV -> q/k RMSNorm -> RoPE -> SDPA -> out projection. A SPLIT-RoPE
    self-attention with the fused route on skips the rotation here: K5
    rotates q and k inside the attention kernel."""
    ctx = x if context is None else context
    q = rms_norm(linear(attn.to_q, x), attn.q_norm.weight, eps=norm_eps)
    k = rms_norm(linear(attn.to_k, ctx), attn.k_norm.weight, eps=norm_eps)
    v = linear(attn.to_v, ctx)
    is_self = context is None and bias is None
    if is_self and rope_type == LTXRopeType.SPLIT and fused_split_rope_eligible(q, heads, pe):
        return linear(attn.to_out, sdpa_flat_fused_rope(q, k, v, heads, pe))
    if pe is not None:
        q = rope_lib.apply_rotary_emb(q, pe, rope_type)
        k = rope_lib.apply_rotary_emb(k, pe, rope_type)
    return linear(attn.to_out, sdpa_flat(q, k, v, heads, bias=bias))


def feed_forward_apply(ff: FeedForward, x: torch.Tensor) -> torch.Tensor:
    """Linear -> GELU(tanh) -> Linear."""
    return linear(ff.proj_out, F.gelu(linear(ff.proj_in, x), approximate="tanh"))


def text_projection_apply(proj: TextProjection, x: torch.Tensor) -> torch.Tensor:
    """2-layer GELU(tanh) MLP."""
    return linear(proj.linear2, F.gelu(linear(proj.linear1, x), approximate="tanh"))


def _ada_values(table: torch.Tensor, timestep: torch.Tensor, start: int, stop: int, num_params: int):
    """Rows [start, stop) of the adaLN modulation, each (B, S_t, dim):
    table (num_params, dim) plus timestep (B, S_t, num_params*dim)."""
    b, s_t = timestep.shape[0], timestep.shape[1]
    ts = timestep.reshape(b, s_t, num_params, -1)
    return tuple(table[i][None, None, :] + ts[:, :, i, :] for i in range(start, stop))


class _ModalityArgs(NamedTuple):
    """Per-modality tensors threaded through the blocks."""

    x: torch.Tensor
    context: torch.Tensor
    context_bias: Optional[torch.Tensor]
    timesteps: torch.Tensor  # (B, S_t, 6*dim) modulation
    embedded_timestep: torch.Tensor  # (B, S_t, dim)
    pe: Tuple[torch.Tensor, torch.Tensor]


def block_apply(
    block: TransformerBlock,
    video: _ModalityArgs,
    heads: int,
    rope_type: LTXRopeType,
    norm_eps: float,
) -> torch.Tensor:
    """Video branch of one transformer block; returns the new hidden state."""
    vx = video.x
    vshift, vscale, vgate = _ada_values(block.scale_shift_table, video.timesteps, 0, 3, 6)
    norm_vx = rms_norm(vx, eps=norm_eps) * (1 + vscale) + vshift
    vx = vx + attention_apply(block.attn1, norm_vx, heads, rope_type, norm_eps, pe=video.pe) * vgate
    vx = vx + attention_apply(
        block.attn2, rms_norm(vx, eps=norm_eps), heads, rope_type, norm_eps,
        context=video.context, bias=video.context_bias,
    )
    vshift_mlp, vscale_mlp, vgate_mlp = _ada_values(block.scale_shift_table, video.timesteps, 3, 6, 6)
    vx_scaled = rms_norm(vx, eps=norm_eps) * (1 + vscale_mlp) + vshift_mlp
    return vx + feed_forward_apply(block.ff, vx_scaled) * vgate_mlp


def _context_bias(context_mask: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    """0/1 mask -> additive bias (B, 1, 1, S_ctx); float masks pass through."""
    if context_mask is None:
        return None
    if context_mask.is_floating_point():
        return context_mask
    bias = (context_mask.to(dtype) - 1.0) * 1e9
    return bias.reshape(context_mask.shape[0], 1, 1, context_mask.shape[-1])


def prepare_ltx_args(model: LTXModel, config: LTXModelConfig, video: Modality) -> _ModalityArgs:
    """Patchify projection, adaLN timestep embeds, caption projection, RoPE."""
    vp = model.video
    x = linear(vp.patchify_proj, video.latent)
    b = x.shape[0]
    t_scaled = video.timesteps * config.timestep_scale_multiplier
    modulation, embedded = adaln_apply(vp.adaln_single, t_scaled.reshape(-1), x.dtype)
    context = text_projection_apply(vp.caption_projection, video.context).reshape(b, -1, x.shape[-1])
    pe = video.pe
    if pe is None:
        if video.positions is None:
            raise ValueError("Modality needs either precomputed pe or positions")
        pe = rope_lib.precompute_freqs_cis(
            video.positions,
            dim=config.inner_dim,
            theta=config.positional_embedding_theta,
            max_pos=config.positional_embedding_max_pos,
            use_middle_indices_grid=config.use_middle_indices_grid,
            num_attention_heads=config.num_attention_heads,
            rope_type=config.rope_type,
            double_precision=config.double_precision_rope,
        )
    return _ModalityArgs(
        x=x,
        context=context,
        context_bias=_context_bias(video.context_mask, video.latent.dtype),
        timesteps=modulation.reshape(b, -1, modulation.shape[-1]),
        embedded_timestep=embedded.reshape(b, -1, embedded.shape[-1]),
        pe=pe,
    )


def _process_output(vp: VideoParams, x: torch.Tensor, embedded_timestep: torch.Tensor, norm_eps: float):
    """Output head: LayerNorm (no affine) -> modulate -> projection."""
    table = vp.scale_shift_table
    shift = table[0][None, None, :] + embedded_timestep
    scale = table[1][None, None, :] + embedded_timestep
    x = layer_norm(x, eps=norm_eps) * (1 + scale) + shift
    return linear(vp.proj_out, x)


def ltx_apply(model: LTXModel, config: LTXModelConfig, video: Modality) -> torch.Tensor:
    """Full DiT forward; returns the video velocity (B, S, out_channels)."""
    args = prepare_ltx_args(model, config, video)
    heads = config.num_attention_heads
    x = args.x
    remat = config.gradient_checkpointing and torch.is_grad_enabled()
    for block in model.blocks:
        block_args = (block, args._replace(x=x), heads, config.rope_type, config.norm_eps)
        x = checkpoint(block_apply, *block_args, use_reentrant=False) if remat else block_apply(*block_args)
    return _process_output(model.video, x, args.embedded_timestep, config.norm_eps)


def to_denoised(noisy: torch.Tensor, velocity: torch.Tensor, sigma) -> torch.Tensor:
    """x0 = x_t - sigma * v in fp32, returned in noisy's dtype."""
    sigma_f32 = torch.as_tensor(sigma, dtype=torch.float32, device=noisy.device)
    while sigma_f32.dim() < velocity.dim():
        sigma_f32 = sigma_f32[..., None]
    return (noisy.float() - sigma_f32 * velocity.float()).to(noisy.dtype)
