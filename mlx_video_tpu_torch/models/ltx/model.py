"""LTX-2 diffusion transformer in PyTorch: the VideoOnly, AudioVideo and
AudioOnly model types.

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

An AudioVideo block runs, in the JAX order: video self- and text attention;
audio self- and text attention; the two cross-modal attentions
(audio-to-video, then video-to-audio) on the RMS-normed streams after that,
each modulated by its 4-entry scale/shift table and gated by its 1-entry
table; then both feed-forwards. The cross-modal attentions use the audio
head geometry in both directions and rotate q and k by different tables
(``pe`` and ``k_pe``): the cross-modal RoPE over the shared time axis.

Pyramid Attention Broadcast (``ltx_apply(..., pab=...)``, video only): a
"collect" forward also returns every block's pre-gate self-attention output;
a forward given those outputs reuses them and skips each block's whole
self-attention (q/k/v/out projections, norms, RoPE and the attention
kernel), while the adaLN gate, the text attention and the feed-forward run
fresh.

Sharded forward (parallel/): a model from parallel/sharding.py:shard_params
carries its mesh (``model.mesh``) and its tensors' specs, and
:func:`ltx_apply` then runs rank-local (:func:`sharded_apply`, every model
type): the batch cut over ``data`` when it divides; the per-modality
projections, the cross-modal adaLNs and the output heads on fully gathered
copies of their tensors; each block on its ``fsdp``-gathered tensors with
``heads / tensor`` local heads in every attention (video, audio and both
cross-modal ones; the RoPE and cross-modal RoPE tables cut to them), its
row-parallel linears and q/k norms summed over ``tensor`` (ops/linear.py,
ops/norms.py). ``sp=(mesh, "fsdp")`` cuts the video tokens over ``fsdp``
when they divide, and the video self-attention becomes the ring
(parallel/ring_attention.py) over their blocks; text attention keeps the
whole caption. The audio stream stays whole on every rank (JAX rings its
self-attention too when its token count divides the axis: the same
function): audio-to-video attention takes this rank's video block as
queries over all the audio, and video-to-audio attention all-gathers the
modulated video context over the ring first. The fused-RoPE route (K5) is
off whenever ``sp`` is given, as in JAX. The last block's video tokens and
the batch are all-gathered, so every rank returns the whole velocities.

The rank-local forward is differentiable (the sharded trainer): its
gathers carry gradients back to the shards (parallel/sharding.py:gather,
collectives.gather_sum for the ring's and the batch's gathers), the
tensor-parallel linears and norms are Megatron's (ops/linear.py,
ops/norms.py), the ring has its backward, and with gradient checkpointing
each block's gather runs inside its checkpoint, so a block's whole tensors
live only while it runs, forward and again in the backward.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mlx_video_tpu_torch.config import LTXModelConfig, LTXRopeType, TransformerConfig
from mlx_video_tpu_torch.models.ltx import rope as rope_lib
from mlx_video_tpu_torch.ops.attention import fused_split_rope_eligible, sdpa_flat, sdpa_flat_fused_rope
from mlx_video_tpu_torch.ops.linear import Linear, init_linear_, linear
from mlx_video_tpu_torch.ops.norms import layer_norm, rms_norm
from mlx_video_tpu_torch.parallel.collectives import SoloGroup, gather_sum, mesh_groups
from mlx_video_tpu_torch.parallel.ring_attention import ring_attention


class Modality(NamedTuple):
    """Pipeline -> model interface.

    latent:    (B, S, C) flattened latent tokens
    timesteps: (B, S_t) per-token sigmas, S_t in {1, S}
    context:   (B, S_ctx, caption_channels) text context
    positions: (B, n_dims, S, 2) pixel-space [start, end) bounds, or None when
               ``pe`` is given
    context_mask: optional (B, S_ctx) 0/1 mask (converted to additive bias)
    pe:        optional precomputed (cos, sin) RoPE tables
    cross_pe:  optional precomputed (cos, sin) cross-modal RoPE tables; the AV
               path derives them from ``positions`` when absent
    """

    latent: torch.Tensor
    timesteps: torch.Tensor
    context: torch.Tensor
    positions: Optional[torch.Tensor] = None
    context_mask: Optional[torch.Tensor] = None
    pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    cross_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


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
    """One block: the video branch (self-attention, text cross-attention,
    FFN), the audio branch (the same at the audio width) and, when both are
    there, the cross-modal attentions and their tables."""

    def __init__(self, video: Optional[TransformerConfig], audio: Optional[TransformerConfig],
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        if video is not None:
            self.attn1 = Attention(video.dim, video.heads, video.d_head, **kw)
            self.attn2 = Attention(video.dim, video.heads, video.d_head, context_dim=video.context_dim, **kw)
            self.ff = FeedForward(video.dim, **kw)
            self.scale_shift_table = _param(6, video.dim, **kw)
        if audio is not None:
            self.audio_attn1 = Attention(audio.dim, audio.heads, audio.d_head, **kw)
            self.audio_attn2 = Attention(audio.dim, audio.heads, audio.d_head, context_dim=audio.context_dim, **kw)
            self.audio_ff = FeedForward(audio.dim, **kw)
            self.audio_scale_shift_table = _param(6, audio.dim, **kw)
        if video is not None and audio is not None:
            self.audio_to_video_attn = Attention(video.dim, audio.heads, audio.d_head, context_dim=audio.dim, **kw)
            self.video_to_audio_attn = Attention(audio.dim, audio.heads, audio.d_head, context_dim=video.dim, **kw)
            self.scale_shift_table_a2v_ca_audio = _param(5, audio.dim, **kw)
            self.scale_shift_table_a2v_ca_video = _param(5, video.dim, **kw)


class ModalityParams(nn.Module):
    """Per-modality input/output projections (the JAX ``params["video"]``
    and ``params["audio"]``)."""

    def __init__(self, in_channels: int, dim: int, caption_channels: int, out_channels: int,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.patchify_proj = Linear(in_channels, dim, **kw)
        self.adaln_single = AdaLayerNormSingle(dim, 6, **kw)
        self.caption_projection = TextProjection(caption_channels, dim, **kw)
        self.scale_shift_table = _param(2, dim, **kw)
        self.proj_out = Linear(dim, out_channels, **kw)


class AVParams(nn.Module):
    """The cross-modal adaLNs (the JAX ``params["av"]``): 4-coefficient
    scale/shift and 1-coefficient gate embeddings for each stream."""

    def __init__(self, config: LTXModelConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.av_ca_video_scale_shift_adaln = AdaLayerNormSingle(config.inner_dim, 4, **kw)
        self.av_ca_audio_scale_shift_adaln = AdaLayerNormSingle(config.audio_inner_dim, 4, **kw)
        self.av_ca_a2v_gate_adaln = AdaLayerNormSingle(config.inner_dim, 1, **kw)
        self.av_ca_v2a_gate_adaln = AdaLayerNormSingle(config.audio_inner_dim, 1, **kw)


class LTXModel(nn.Module):
    """LTX-2 DiT parameters of any model type; the forward is :func:`ltx_apply`.

    ``video`` exists when the model type has video, ``audio`` when it has
    audio, ``av`` when it has both; each block holds the branches of its
    modalities (an AudioOnly model has no video parameter at all).

    Built on ``device="meta"`` it is a skeleton that holds no memory, for a
    loader to fill with ``load_state_dict(..., assign=True)``; before that,
    ``ops/quant.py:use_quant_linears`` turns the linears a checkpoint holds
    packed into ``QuantLinear``s.
    """

    def __init__(self, config: LTXModelConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        video = config.get_video_config()
        audio = config.get_audio_config()
        kw = dict(device=device, dtype=dtype)
        if video is not None:
            self.video = ModalityParams(config.in_channels, video.dim, config.caption_channels,
                                        config.out_channels, **kw)
        if audio is not None:
            self.audio = ModalityParams(config.audio_in_channels, audio.dim, config.audio_caption_channels,
                                        config.audio_out_channels, **kw)
        if video is not None and audio is not None:
            self.av = AVParams(config, **kw)
        self.blocks = nn.ModuleList(TransformerBlock(video, audio, **kw) for _ in range(config.num_layers))


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
    return init_params_(LTXModel(config, device="meta", dtype=dtype), generator, device)


@torch.no_grad()
def init_params_(model: nn.Module, generator: torch.Generator, device) -> nn.Module:
    """Give every parameter of ``model`` still on the ``meta`` device storage
    on ``device`` and draw it as :func:`init_ltx_params` does, in module
    order; parameters that already hold storage (modules shared with another
    model) are left as they are. Returns ``model``."""
    for module in model.modules():
        fresh = [n for n, p in module.named_parameters(recurse=False) if p.is_meta]
        for name in fresh:
            p = module._parameters[name]
            module._parameters[name] = nn.Parameter(torch.empty(p.shape, dtype=p.dtype, device=device),
                                                    requires_grad=False)
        if not fresh:
            continue
        if isinstance(module, Linear):
            init_linear_(module, generator)
        elif isinstance(module, RMSNormWeight):
            module.weight.fill_(1.0)
        for name in fresh:
            if "scale_shift_table" in name:
                module._parameters[name].zero_()
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
    k_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    sp=None,
) -> torch.Tensor:
    """QKV -> q/k RMSNorm -> RoPE -> SDPA -> out projection. q rotates by
    ``pe`` and k by ``k_pe`` when given (the cross-modal attentions), else by
    ``pe``. A SPLIT-RoPE self-attention with the fused route on skips the
    rotation here: K5 rotates q and k inside the attention kernel. ``sp``
    (a group of the collective layer; the fused route is off with it): a
    self-attention over this rank's block of tokens runs as ring attention
    over the group when it has more than one rank."""
    ctx = x if context is None else context
    q = rms_norm(linear(attn.to_q, x), attn.q_norm.weight, eps=norm_eps,
                 group=getattr(attn.q_norm, "tp_group", None))
    k = rms_norm(linear(attn.to_k, ctx), attn.k_norm.weight, eps=norm_eps,
                 group=getattr(attn.k_norm, "tp_group", None))
    v = linear(attn.to_v, ctx)
    is_self = context is None and k_pe is None and bias is None
    if sp is None and is_self and rope_type == LTXRopeType.SPLIT and fused_split_rope_eligible(q, heads, pe):
        return linear(attn.to_out, sdpa_flat_fused_rope(q, k, v, heads, pe))
    if pe is not None:
        q = rope_lib.apply_rotary_emb(q, pe, rope_type)
        k = rope_lib.apply_rotary_emb(k, pe if k_pe is None else k_pe, rope_type)
    if sp is not None and is_self and sp.size > 1:
        b, s, dim = q.shape
        d_head = dim // heads
        out = ring_attention(q.reshape(b, s, heads, d_head), k.reshape(b, s, heads, d_head),
                             v.reshape(b, s, heads, d_head), sp)
        return linear(attn.to_out, out.reshape(b, s, dim))
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
    """Per-modality tensors threaded through the blocks; the cross-modal
    entries are set on the AV path only."""

    x: torch.Tensor
    context: torch.Tensor
    context_bias: Optional[torch.Tensor]
    timesteps: torch.Tensor  # (B, S_t, 6*dim) modulation
    embedded_timestep: torch.Tensor  # (B, S_t, dim)
    pe: Tuple[torch.Tensor, torch.Tensor]
    cross_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    cross_scale_shift_timestep: Optional[torch.Tensor] = None  # (B, S_t, 4*dim)
    cross_gate_timestep: Optional[torch.Tensor] = None  # (B, S_t, dim)
    # the cross-modal tables over all the stream's tokens, where the stream is
    # cut over an SP ring (the other stream's cross-modal keys see them all)
    cross_k_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def _self_and_text(attn1: Attention, attn2: Attention, table: torch.Tensor, m: _ModalityArgs, x: torch.Tensor,
                   heads: int, rope_type: LTXRopeType, norm_eps: float, cached: Optional[torch.Tensor] = None,
                   sp=None):
    """Gated self-attention on the modulated stream, then text attention;
    returns the new stream and the pre-gate self-attention output (``cached``
    when given, in place of computing it)."""
    shift, scale, gate = _ada_values(table, m.timesteps, 0, 3, 6)
    a1 = cached
    if a1 is None:
        norm_x = rms_norm(x, eps=norm_eps) * (1 + scale) + shift
        a1 = attention_apply(attn1, norm_x, heads, rope_type, norm_eps, pe=m.pe, sp=sp)
    x = x + a1 * gate
    return x + attention_apply(
        attn2, rms_norm(x, eps=norm_eps), heads, rope_type, norm_eps, context=m.context, bias=m.context_bias,
    ), a1


def _gated_ff(ff: FeedForward, table: torch.Tensor, m: _ModalityArgs, x: torch.Tensor, norm_eps: float):
    shift, scale, gate = _ada_values(table, m.timesteps, 3, 6, 6)
    return x + feed_forward_apply(ff, rms_norm(x, eps=norm_eps) * (1 + scale) + shift) * gate


def block_apply(
    block: TransformerBlock,
    video: Optional[_ModalityArgs],
    audio: Optional[_ModalityArgs],
    video_cfg: Optional[TransformerConfig],
    audio_cfg: Optional[TransformerConfig],
    rope_type: LTXRopeType,
    norm_eps: float,
    attn_cache: Optional[torch.Tensor] = None,
    collect_attn: bool = False,
    sp=None,
):
    """One transformer block over the modalities given; returns the new
    (video, audio) hidden states, None for a modality not given. PAB (video
    only): ``attn_cache`` is the block's pre-gate self-attention output of
    an earlier step, used in place of computing it; ``collect_attn`` adds
    this step's as a third result. ``sp``: the video self-attention's ring
    group (:func:`attention_apply`); the audio, whole on every rank, then
    attends locally (the fused route off, as JAX's ``sp`` turns it off) and
    video-to-audio attention gathers the video context over the ring."""
    vx = None if video is None else video.x
    ax = None if audio is None else audio.x
    a1 = None
    if video is not None:
        vx, a1 = _self_and_text(block.attn1, block.attn2, block.scale_shift_table, video, vx,
                                video_cfg.heads, rope_type, norm_eps, attn_cache, sp)
    if audio is not None:
        ax, _ = _self_and_text(block.audio_attn1, block.audio_attn2, block.audio_scale_shift_table, audio, ax,
                               audio_cfg.heads, rope_type, norm_eps, sp=None if sp is None else SoloGroup())
    if video is not None and audio is not None:
        vx_norm3 = rms_norm(vx, eps=norm_eps)
        ax_norm3 = rms_norm(ax, eps=norm_eps)
        a_tab, v_tab = block.scale_shift_table_a2v_ca_audio, block.scale_shift_table_a2v_ca_video
        scale_a_a2v, shift_a_a2v, scale_a_v2a, shift_a_v2a = _ada_values(
            a_tab[:4], audio.cross_scale_shift_timestep, 0, 4, 4)
        (gate_v2a,) = _ada_values(a_tab[4:], audio.cross_gate_timestep, 0, 1, 1)
        scale_v_a2v, shift_v_a2v, scale_v_v2a, shift_v_v2a = _ada_values(
            v_tab[:4], video.cross_scale_shift_timestep, 0, 4, 4)
        (gate_a2v,) = _ada_values(v_tab[4:], video.cross_gate_timestep, 0, 1, 1)
        vx = vx + attention_apply(
            block.audio_to_video_attn, vx_norm3 * (1 + scale_v_a2v) + shift_v_a2v, audio_cfg.heads, rope_type,
            norm_eps, context=ax_norm3 * (1 + scale_a_a2v) + shift_a_a2v, pe=video.cross_pe, k_pe=audio.cross_pe,
        ) * gate_a2v
        v_ctx, v_kpe = vx_norm3 * (1 + scale_v_v2a) + shift_v_v2a, video.cross_pe
        if sp is not None and sp.size > 1:  # this rank holds a block of the video: v2a's keys need all of it
            v_ctx, v_kpe = gather_sum(v_ctx, sp, dim=1), video.cross_k_pe
        ax = ax + attention_apply(
            block.video_to_audio_attn, ax_norm3 * (1 + scale_a_v2a) + shift_a_v2a, audio_cfg.heads, rope_type,
            norm_eps, context=v_ctx, pe=audio.cross_pe, k_pe=v_kpe,
        ) * gate_v2a
    if video is not None:
        vx = _gated_ff(block.ff, block.scale_shift_table, video, vx, norm_eps)
    if audio is not None:
        ax = _gated_ff(block.audio_ff, block.audio_scale_shift_table, audio, ax, norm_eps)
    if collect_attn:
        return vx, ax, a1
    return vx, ax


def _context_bias(context_mask: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    """0/1 mask -> additive bias (B, 1, 1, S_ctx); float masks pass through."""
    if context_mask is None:
        return None
    if context_mask.is_floating_point():
        return context_mask
    bias = (context_mask.to(dtype) - 1.0) * 1e9
    return bias.reshape(context_mask.shape[0], 1, 1, context_mask.shape[-1])


def _rope(config: LTXModelConfig, positions: torch.Tensor, dim: int, max_pos, heads: int,
          use_middle_indices_grid: bool):
    return rope_lib.precompute_freqs_cis(
        positions,
        dim=dim,
        theta=config.positional_embedding_theta,
        max_pos=max_pos,
        use_middle_indices_grid=use_middle_indices_grid,
        num_attention_heads=heads,
        rope_type=config.rope_type,
        double_precision=config.double_precision_rope,
    )


def _prepare_modality(
    mp: ModalityParams,
    m: Modality,
    config: LTXModelConfig,
    dim: int,
    max_pos,
    heads: int,
    av: Optional[AVParams] = None,
    cross_keys: Tuple[str, str] = ("", ""),
    cross_pe_max_pos: Optional[int] = None,
) -> _ModalityArgs:
    """Patchify projection, adaLN timestep embeds, caption projection, RoPE;
    with ``av``, the cross-modal RoPE over the time axis and the cross
    scale/shift and gate modulations (adaLNs ``cross_keys`` of ``av``)."""
    x = linear(mp.patchify_proj, m.latent)
    b = x.shape[0]
    t_scaled = m.timesteps * config.timestep_scale_multiplier
    modulation, embedded = adaln_apply(mp.adaln_single, t_scaled.reshape(-1), x.dtype)
    context = text_projection_apply(mp.caption_projection, m.context).reshape(b, -1, x.shape[-1])
    pe = m.pe
    if pe is None:
        if m.positions is None:
            raise ValueError("Modality needs either precomputed pe or positions")
        pe = _rope(config, m.positions, dim, max_pos, heads, config.use_middle_indices_grid)
    cross = {}
    if av is not None:
        cross_pe = m.cross_pe
        if cross_pe is None:
            if m.positions is None:
                raise ValueError(
                    "AV (audio+video) mode derives the cross-modal RoPE from the positions' time axis: pass "
                    "positions, or precompute and pass Modality.cross_pe alongside pe"
                )
            cross_pe = _rope(config, m.positions[:, 0:1], config.audio_cross_attention_dim, [cross_pe_max_pos],
                             heads, True)
        av_factor = config.av_ca_timestep_scale_multiplier / config.timestep_scale_multiplier
        ss_key, gate_key = cross_keys
        cross_ss, _ = adaln_apply(getattr(av, ss_key), t_scaled.reshape(-1), x.dtype)
        cross_gate, _ = adaln_apply(getattr(av, gate_key), t_scaled.reshape(-1) * av_factor, x.dtype)
        cross = dict(cross_pe=cross_pe, cross_scale_shift_timestep=cross_ss.reshape(b, -1, cross_ss.shape[-1]),
                     cross_gate_timestep=cross_gate.reshape(b, -1, cross_gate.shape[-1]))
    return _ModalityArgs(
        x=x,
        context=context,
        context_bias=_context_bias(m.context_mask, m.latent.dtype),
        timesteps=modulation.reshape(b, -1, modulation.shape[-1]),
        embedded_timestep=embedded.reshape(b, -1, embedded.shape[-1]),
        pe=pe,
        **cross,
    )


def prepare_ltx_args(
    model: LTXModel, config: LTXModelConfig, video: Optional[Modality] = None, audio: Optional[Modality] = None,
) -> Tuple[Optional[_ModalityArgs], Optional[_ModalityArgs]]:
    """The per-modality block inputs; the cross-modal ones when both
    modalities are given."""
    if video is not None and config.get_video_config() is None:
        raise ValueError("Video is not enabled for this model")
    if audio is not None and config.get_audio_config() is None:
        raise ValueError("Audio is not enabled for this model")
    both = video is not None and audio is not None
    av = model.av if both else None
    cross_max = None
    if both:
        cross_max = max(config.positional_embedding_max_pos[0], config.audio_positional_embedding_max_pos[0])
    video_args = audio_args = None
    if video is not None:
        video_args = _prepare_modality(
            model.video, video, config, config.inner_dim, config.positional_embedding_max_pos,
            config.num_attention_heads, av, ("av_ca_video_scale_shift_adaln", "av_ca_a2v_gate_adaln"), cross_max,
        )
    if audio is not None:
        audio_args = _prepare_modality(
            model.audio, audio, config, config.audio_inner_dim, config.audio_positional_embedding_max_pos,
            config.audio_num_attention_heads, av, ("av_ca_audio_scale_shift_adaln", "av_ca_v2a_gate_adaln"),
            cross_max,
        )
    return video_args, audio_args


def _process_output(mp: ModalityParams, x: torch.Tensor, embedded_timestep: torch.Tensor, norm_eps: float):
    """Output head: LayerNorm (no affine) -> modulate -> projection."""
    table = mp.scale_shift_table
    shift = table[0][None, None, :] + embedded_timestep
    scale = table[1][None, None, :] + embedded_timestep
    x = layer_norm(x, eps=norm_eps) * (1 + scale) + shift
    return linear(mp.proj_out, x)


def ltx_apply(
    model: LTXModel, config: LTXModelConfig, video: Optional[Modality] = None, audio: Optional[Modality] = None,
    pab=None, sp=None,
):
    """Full DiT forward; returns the (video, audio) velocities, (B, S,
    out_channels) each, None for a modality not given.

    ``pab`` (Pyramid Attention Broadcast, video only): ``"collect"`` adds a
    third result, ``{"self": [each block's pre-gate self-attention output]}``;
    passing such a cache back reuses those outputs and skips every block's
    self-attention.

    A sharded model (``model.mesh``), or ``sp=(mesh, axis)``: the rank-local
    forward of the module docstring (:func:`sharded_apply`)."""
    collect = isinstance(pab, str) and pab == "collect"
    cache = None if pab is None or collect else pab["self"]
    if pab is not None and audio is not None:
        raise ValueError("pab attention broadcast supports the video-only path")
    if getattr(model, "pipe_axis", None) is not None:
        raise ValueError("a pipeline stage holds only its own blocks: run it through "
                         "parallel/pipeline.py:pipeline_ltx_apply (denoise's pipeline_parallel)")
    if getattr(model, "mesh", None) is not None or sp is not None:
        return sharded_apply(model, config, video, audio, sp=sp, cache=cache, collect=collect)
    video_args, audio_args = prepare_ltx_args(model, config, video, audio)
    video_cfg, audio_cfg = config.get_video_config(), config.get_audio_config()
    vx = None if video_args is None else video_args.x
    ax = None if audio_args is None else audio_args.x
    remat = config.gradient_checkpointing and torch.is_grad_enabled()
    collected = []
    for i, block in enumerate(model.blocks):
        block_args = (
            block,
            None if video_args is None else video_args._replace(x=vx),
            None if audio_args is None else audio_args._replace(x=ax),
            video_cfg, audio_cfg, config.rope_type, config.norm_eps,
            None if cache is None else cache[i], collect,
        )
        out = checkpoint(block_apply, *block_args, use_reentrant=False) if remat else block_apply(*block_args)
        vx, ax = out[0], out[1]
        if collect:
            collected.append(out[2])
    v_out = None if video_args is None else _process_output(model.video, vx, video_args.embedded_timestep,
                                                             config.norm_eps)
    a_out = None if audio_args is None else _process_output(model.audio, ax, audio_args.embedded_timestep,
                                                             config.norm_eps)
    if collect:
        return v_out, a_out, {"self": collected}
    return v_out, a_out


# ---------------------------------------------------------------------------
# Rank-local forward (parallel/)
# ---------------------------------------------------------------------------


def batch_slice(m, start: int, size: int):
    """Rows [start, start + size) of every batched tensor of a Modality or
    _ModalityArgs (tuples of tensors, such as RoPE tables, cut each)."""
    def cut(v):
        if isinstance(v, torch.Tensor):
            return v[start:start + size]
        if isinstance(v, tuple):
            return tuple(cut(t) for t in v)
        return v

    return type(m)(*(cut(v) for v in m))


def _cut(t: torch.Tensor, dim: int, parts: int, idx: int) -> torch.Tensor:
    step = t.shape[dim] // parts
    return t.narrow(dim, idx * step, step).contiguous()


def local_block_args(args: _ModalityArgs, rope_type: LTXRopeType, mesh, tp: int, ring) -> _ModalityArgs:
    """A block's inputs on this rank: with ``tp`` > 1 the RoPE and
    cross-modal RoPE tables of its ``heads / tp`` local heads (the
    ``tensor`` index's), and with a ``ring`` group its block of the tokens
    (the stream, the per-token modulations and tables; the whole cross-modal
    tables kept as ``cross_k_pe``)."""
    split = rope_type == LTXRopeType.SPLIT  # (B, H, S, D/2) tables, else (B, S, H*D)
    head_dim, token_dim = (1, 2) if split else (2, 1)

    def tables(pair, dim: int, parts: int, idx: int):
        return None if pair is None else tuple(_cut(c, dim, parts, idx) for c in pair)

    pe, cross_pe = args.pe, args.cross_pe
    if tp > 1:
        t = mesh.index("tensor")
        pe, cross_pe = tables(pe, head_dim, tp, t), tables(cross_pe, head_dim, tp, t)
    args = args._replace(pe=pe, cross_pe=cross_pe)
    if ring is None or ring.size == 1:
        return args
    n, r, s = ring.size, ring.rank, args.x.shape[1]

    def per_token(t):
        return _cut(t, 1, n, r) if t is not None and t.shape[1] == s else t

    return args._replace(
        x=_cut(args.x, 1, n, r), timesteps=per_token(args.timesteps), pe=tables(pe, token_dim, n, r),
        cross_pe=tables(cross_pe, token_dim, n, r), cross_k_pe=cross_pe,
        cross_scale_shift_timestep=per_token(args.cross_scale_shift_timestep),
        cross_gate_timestep=per_token(args.cross_gate_timestep),
    )


def run_blocks(model: LTXModel, video: Optional[_ModalityArgs], audio: Optional[_ModalityArgs],
               video_cfg: Optional[TransformerConfig], audio_cfg: Optional[TransformerConfig], config: LTXModelConfig,
               ring=None, cache=None, collected=None):
    """The streams ``video.x`` and ``audio.x`` (either may be None) through
    ``model.blocks``, each block on its ``fsdp``-gathered tensors, dropped
    after it runs (gathered again in the backward under gradient
    checkpointing); returns the (video, audio) streams. PAB's per-block cache
    and collection as in :func:`ltx_apply`."""
    from mlx_video_tpu_torch.parallel.sharding import gather

    specs = getattr(model, "shard_specs", None)
    remat = config.gradient_checkpointing and torch.is_grad_enabled()

    def step(block, i, v_args, a_args):
        if specs is not None:
            block = gather(block, specs, model.mesh, axes=("fsdp",), prefix=f"blocks.{i}.")
        return block_apply(block, v_args, a_args, video_cfg, audio_cfg, config.rope_type, config.norm_eps,
                           None if cache is None else cache[i], collected is not None, sp=ring)

    vx = None if video is None else video.x
    ax = None if audio is None else audio.x
    for i, block in enumerate(model.blocks):
        args = (block, i, None if video is None else video._replace(x=vx),
                None if audio is None else audio._replace(x=ax))
        out = checkpoint(step, *args, use_reentrant=False) if remat else step(*args)
        vx, ax = out[0], out[1]
        if collected is not None:
            collected.append(out[2])
    return vx, ax


def gathered_heads(model: LTXModel):
    """The per-modality projections and heads and the cross-modal adaLNs
    (``video``, ``audio``, ``av``, those the model has), fully gathered on a
    sharded model."""
    from mlx_video_tpu_torch.parallel.sharding import gather

    specs = getattr(model, "shard_specs", None)
    parts = {name: getattr(model, name) for name in ("video", "audio", "av") if hasattr(model, name)}
    if specs is not None:
        parts = {name: gather(m, specs, model.mesh, prefix=f"{name}.") for name, m in parts.items()}
    return SimpleNamespace(**parts)


def local_configs(config: LTXModelConfig, video, audio, tp: int):
    """The (video, audio) block configs of the modalities given, with the
    ``heads / tp`` local heads of a rank."""
    def local(cfg):
        return dataclasses.replace(cfg, heads=cfg.heads // tp)

    return (None if video is None else local(config.get_video_config()),
            None if audio is None else local(config.get_audio_config()))


def sharded_apply(model: LTXModel, config: LTXModelConfig, video: Optional[Modality],
                  audio: Optional[Modality] = None, sp=None, cache=None, collect: bool = False):
    """The rank-local forward of a sharded model of any type (or of a whole
    one under ``sp``); every rank returns the whole (video, audio)
    velocities."""
    specs = getattr(model, "shard_specs", None)
    mesh = model.mesh if specs is not None else mesh_groups(sp[0])
    tp = mesh.size("tensor") if specs is not None else 1
    data = mesh.group("data")
    b = (video if video is not None else audio).latent.shape[0]
    by_data = data.size > 1 and b % data.size == 0
    if by_data:
        lo, n = data.rank * (b // data.size), b // data.size
        video = None if video is None else batch_slice(video, lo, n)
        audio = None if audio is None else batch_slice(audio, lo, n)
    heads = gathered_heads(model)
    video_args, audio_args = prepare_ltx_args(heads, config, video, audio)
    ring = None
    if sp is not None:
        ring = mesh.group(sp[1])
        if video_args is None or ring.size == 1 or video_args.x.shape[1] % ring.size:
            ring = SoloGroup()  # local attention over all the tokens, the fused route still off
    v_local = None if video_args is None else local_block_args(video_args, config.rope_type, mesh, tp, ring)
    a_local = None if audio_args is None else local_block_args(audio_args, config.rope_type, mesh, tp, None)
    video_cfg, audio_cfg = local_configs(config, video, audio, tp)
    collected = [] if collect else None
    vx, ax = run_blocks(model, v_local, a_local, video_cfg, audio_cfg, config, ring, cache, collected)
    if ring is not None and ring.size > 1:
        vx = gather_sum(vx, ring, dim=1)
    v_out = None if video_args is None else _process_output(heads.video, vx, video_args.embedded_timestep,
                                                             config.norm_eps)
    a_out = None if audio_args is None else _process_output(heads.audio, ax, audio_args.embedded_timestep,
                                                             config.norm_eps)
    if by_data:
        v_out = None if v_out is None else gather_sum(v_out, data, dim=0)
        a_out = None if a_out is None else gather_sum(a_out, data, dim=0)
    if collect:
        return v_out, a_out, {"self": collected}
    return v_out, a_out


def to_denoised(noisy: torch.Tensor, velocity: torch.Tensor, sigma) -> torch.Tensor:
    """x0 = x_t - sigma * v in fp32, returned in noisy's dtype."""
    sigma_f32 = torch.as_tensor(sigma, dtype=torch.float32, device=noisy.device)
    while sigma_f32.dim() < velocity.dim():
        sigma_f32 = sigma_f32[..., None]
    return (noisy.float() - sigma_f32 * velocity.float()).to(noisy.dtype)
