"""Gemma-3 text model: the hidden states the LTX-2 text encoder reads.

Counterpart of mlx_video_tpu/models/gemma3.py (``Gemma3TextConfig``,
``gemma_rms_norm``, ``_rope_neox``, ``_attention``, ``causal_mask_bias``,
``_layer_schedule``, ``gemma3_hidden_states``, ``gemma3_logits``,
``init_kv_caches``, ``generate``), plain PyTorch as it is plain XLA there:

- embeddings scaled by sqrt(hidden_size), the scalar rounded to the
  embeddings' dtype first;
- sandwich-norm layers (input, post-attention, pre- and post-feedforward
  Gemma RMSNorms, which scale by 1 + weight, in fp32);
- GQA attention with per-head q/k RMSNorm, rotate-half (NEOX) RoPE, logits
  and softmax in fp32, query scale query_pre_attn_scalar^-0.5;
- every ``sliding_window_pattern``-th layer global (RoPE theta 1e6, causal
  mask), the others local (theta 1e4, causal mask within the sliding
  window), with -1e9 on masked logits and on padding keys.

The module keeps the JAX tree's names, one ``nn.Module`` per layer
(``layers.{i}``) where JAX stacks them; linears are ``ops/linear.py``
layers in the PyTorch ``(out, in)`` layout (W8A8 makes the projections
``Int8Linear``, ops/int8.py:quantize_text_encoder_w8a8); the embedding table
is (vocab, hidden) in both.

Generation (prompt enhancement): the logits are the tied embedding head in
fp32; the KV caches are full ``max_len`` buffers a layer, written in place
at each step's offset; ``generate`` decodes greedily at temperature <= 0,
else samples after the top-p cutoff. Differences from the JAX function, on
purpose: the draw is ``torch.multinomial`` from the caller's
``torch.Generator`` (JAX's ``jax.random.categorical`` cannot be reproduced),
so only greedy decoding is held token for token against JAX; the fp32 head
is one fp32 copy of the embedding table a ``generate`` call (4 GB at the
12B's 262,208 x 3840), and vocabulary chunks of it elsewhere, never a fresh
copy a token.

Sharded (parallel/sharding.py:shard_params of the text encoder gives the
model ``mesh`` and ``shard_specs``): each layer runs on its ``fsdp``-gathered
tensors with this rank's ``heads / tensor`` query and key/value heads
(q/k/v and gate/up column-cut, ``o_proj`` and ``down_proj`` row-parallel
over ``tensor``; the per-head q/k norms whole), and the KV caches hold this
rank's key/value heads; the embedding table is gathered whole for the
lookup and the head (once a ``generate`` call).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mlx_video_tpu_torch.ops.linear import Linear, init_linear_, linear


@dataclass(frozen=True)
class Gemma3TextConfig:
    vocab_size: int = 262208
    hidden_size: int = 3840
    num_hidden_layers: int = 48
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 256
    intermediate_size: int = 15360
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    rope_local_base_freq: float = 10_000.0
    sliding_window: int = 1024
    sliding_window_pattern: int = 6
    query_pre_attn_scalar: float = 256.0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Gemma3TextConfig":
        d = d.get("text_config", d)
        kw = {f: d[f] for f in cls.__dataclass_fields__ if f in d}
        # newer HF configs express the pattern via layer_types
        if "sliding_window_pattern" not in d and "layer_types" in d:
            types = d["layer_types"]
            kw["sliding_window_pattern"] = (
                types.index("full_attention") + 1 if "full_attention" in types else len(types) + 1
            )
        return cls(**kw)

    def is_global_layer(self, i: int) -> bool:
        return i % self.sliding_window_pattern == self.sliding_window_pattern - 1


class Weight(nn.Module):
    """A module that holds one ``weight`` (a norm's scale, an embedding
    table), so its state name is the JAX tree's path."""

    def __init__(self, *shape: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*shape, device=device, dtype=dtype), requires_grad=False)


class GemmaAttention(nn.Module):
    def __init__(self, config: Gemma3TextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        h, hd = config.hidden_size, config.head_dim
        self.q_proj = Linear(h, config.num_attention_heads * hd, **kw)
        self.k_proj = Linear(h, config.num_key_value_heads * hd, **kw)
        self.v_proj = Linear(h, config.num_key_value_heads * hd, **kw)
        self.o_proj = Linear(config.num_attention_heads * hd, h, **kw)
        self.q_norm = Weight(hd, device=device, dtype=dtype)
        self.k_norm = Weight(hd, device=device, dtype=dtype)


class GemmaMLP(nn.Module):
    def __init__(self, config: Gemma3TextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = Linear(config.hidden_size, config.intermediate_size, **kw)
        self.up_proj = Linear(config.hidden_size, config.intermediate_size, **kw)
        self.down_proj = Linear(config.intermediate_size, config.hidden_size, **kw)


class GemmaLayer(nn.Module):
    def __init__(self, config: Gemma3TextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        for name in ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                     "post_feedforward_layernorm"):
            setattr(self, name, Weight(config.hidden_size, **kw))
        self.self_attn = GemmaAttention(config, **kw)
        self.mlp = GemmaMLP(config, **kw)


class Gemma3Model(nn.Module):
    """The Gemma-3 text stack, created uninitialised (see
    :func:`init_gemma3_params`, or the loader io/text_encoder_weights.py)."""

    def __init__(self, config: Gemma3TextConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = Weight(config.vocab_size, config.hidden_size, **kw)
        self.layers = nn.ModuleList(GemmaLayer(config, **kw) for _ in range(config.num_hidden_layers))
        self.norm = Weight(config.hidden_size, **kw)


@torch.no_grad()
def init_gemma3_params(config: Gemma3TextConfig, generator: torch.Generator, device=None,
                       dtype=torch.bfloat16) -> Gemma3Model:
    """Seeded weights of the JAX init's distributions (not its draws): norms
    zero (scale 1), linears U(-1/sqrt(in), 1/sqrt(in)), embeddings N(0, 0.02^2)."""
    model = Gemma3Model(config, device=device, dtype=dtype)
    for m in model.modules():
        if isinstance(m, Linear):
            init_linear_(m, generator)
        elif isinstance(m, Weight):
            m.weight.zero_()
    table = torch.empty(model.embed_tokens.weight.shape, device=device, dtype=torch.float32)
    model.embed_tokens.weight.copy_(table.normal_(0.0, 0.02, generator=generator))
    return model


def _local_config(model: Gemma3Model, config: Gemma3TextConfig) -> Gemma3TextConfig:
    """``config`` with a sharded model's local query and key/value heads."""
    mesh = getattr(model, "mesh", None)
    tp = 1 if mesh is None else mesh.size("tensor")
    if tp == 1:
        return config
    return replace(config, num_attention_heads=config.num_attention_heads // tp,
                   num_key_value_heads=config.num_key_value_heads // tp)


def _table(model: Gemma3Model) -> torch.Tensor:
    """The embedding table, gathered whole on a sharded model."""
    if getattr(model, "shard_specs", None) is None:
        return model.embed_tokens.weight
    from mlx_video_tpu_torch.parallel.sharding import gather

    return gather(model.embed_tokens, model.shard_specs, model.mesh, prefix="embed_tokens.").weight


def _layers(model: Gemma3Model):
    """The layers, each ``fsdp``-gathered on a sharded model (one at a time)."""
    specs = getattr(model, "shard_specs", None)
    if specs is None:
        yield from model.layers
        return
    from mlx_video_tpu_torch.parallel.sharding import gather

    for i, layer in enumerate(model.layers):
        yield gather(layer, specs, model.mesh, axes=("fsdp",), prefix=f"layers.{i}.")


def gemma_rms_norm(weight: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma RMSNorm: fp32, scale by (1 + weight), output in x's dtype."""
    xf = x.float()
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def _rope_neox(x: torch.Tensor, positions: torch.Tensor, base: float) -> torch.Tensor:
    """Rotate-half RoPE over (B, H, T, D) in fp32; positions (B, T) int; the
    inverse frequencies computed in fp32 as the JAX scan computes them."""
    d = x.shape[-1]
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    # a Python base: a device tensor made from it would be a pageable copy that waits for the stream
    inv_freq = 1.0 / torch.pow(base, exponent)
    angles = positions.float()[:, None, :, None] * inv_freq[None, None, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


@dataclass
class KVCache:
    """One layer's key and value buffers, (B, num_key_value_heads, max_len,
    head_dim), and the offset the next tokens are written at."""

    k: torch.Tensor
    v: torch.Tensor
    offset: int = 0


def _attention(attn: GemmaAttention, x: torch.Tensor, mask_bias: torch.Tensor, positions: torch.Tensor,
               config: Gemma3TextConfig, rope_base: float, kv_cache: Optional[KVCache] = None) -> torch.Tensor:
    b, t, _ = x.shape
    nh, nkv, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    q = linear(attn.q_proj, x).reshape(b, t, nh, hd).transpose(1, 2)
    k = linear(attn.k_proj, x).reshape(b, t, nkv, hd).transpose(1, 2)
    v = linear(attn.v_proj, x).reshape(b, t, nkv, hd).transpose(1, 2)
    q = _rope_neox(gemma_rms_norm(attn.q_norm.weight, q, config.rms_norm_eps), positions, rope_base)
    k = _rope_neox(gemma_rms_norm(attn.k_norm.weight, k, config.rms_norm_eps), positions, rope_base)
    if kv_cache is not None:  # this step's keys and values into the buffers, in place
        end = kv_cache.offset + t
        kv_cache.k[:, :, kv_cache.offset:end] = k
        kv_cache.v[:, :, kv_cache.offset:end] = v
        k, v = kv_cache.k, kv_cache.v
    rep = nh // nkv  # GQA: each kv head serves rep consecutive query heads
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * config.query_pre_attn_scalar**-0.5
    weights = torch.softmax(logits + mask_bias, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", weights, v).transpose(1, 2).reshape(b, t, nh * hd)
    return linear(attn.o_proj, out)


def _mlp(mlp: GemmaMLP, x: torch.Tensor) -> torch.Tensor:
    gate = F.gelu(linear(mlp.gate_proj, x), approximate="tanh")
    return linear(mlp.down_proj, gate * linear(mlp.up_proj, x))


def _layer(layer: GemmaLayer, x: torch.Tensor, mask_bias: torch.Tensor, positions: torch.Tensor,
           config: Gemma3TextConfig, rope_base: float, kv_cache: Optional[KVCache] = None) -> torch.Tensor:
    eps = config.rms_norm_eps
    attn_out = _attention(layer.self_attn, gemma_rms_norm(layer.input_layernorm.weight, x, eps), mask_bias,
                          positions, config, rope_base, kv_cache)
    x = x + gemma_rms_norm(layer.post_attention_layernorm.weight, attn_out, eps)
    mlp_out = _mlp(layer.mlp, gemma_rms_norm(layer.pre_feedforward_layernorm.weight, x, eps))
    return x + gemma_rms_norm(layer.post_feedforward_layernorm.weight, mlp_out, eps)


def causal_mask_bias(seq_len: int, attention_mask: Optional[torch.Tensor], window: Optional[int] = None,
                     device=None) -> torch.Tensor:
    """Additive (B|1, 1, T, T) fp32 bias: 0 where a query may see a key
    (causal, and within ``window`` when given), -1e9 elsewhere, plus -1e9 on
    padding keys (``attention_mask`` (B, T) 1/0)."""
    if attention_mask is not None:
        device = attention_mask.device
    qi = torch.arange(seq_len, device=device)[:, None]
    ki = torch.arange(seq_len, device=device)[None, :]
    allowed = ki <= qi
    if window is not None:
        allowed = allowed & (qi - ki < window)
    bias = torch.where(allowed, 0.0, -1e9).float()[None, None]
    if attention_mask is not None:
        pad = torch.where(attention_mask.bool(), 0.0, -1e9).float()
        bias = bias + pad[:, None, None, :]
    return bias


def _layer_schedule(config: Gemma3TextConfig) -> Tuple[List[bool], List[float]]:
    """Per layer: global or not, and its RoPE base."""
    is_global = [config.is_global_layer(i) for i in range(config.num_hidden_layers)]
    bases = [config.rope_theta if g else config.rope_local_base_freq for g in is_global]
    return is_global, bases


def gemma3_hidden_states(
    model: Gemma3Model,
    config: Gemma3TextConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
) -> List[torch.Tensor]:
    """The num_hidden_layers + 1 hidden states the LTX-2 feature extractor
    reads: the scaled embeddings, the outputs of layers 0..n-2 and the final
    norm of layer n-1's output. Positions are absolute (0..T-1); padding is
    handled by the mask."""
    b, t = input_ids.shape
    h = _table(model)[input_ids]
    h = h * torch.tensor(config.hidden_size**0.5, dtype=h.dtype)
    positions = torch.arange(t, device=h.device)[None].expand(b, t)
    full_bias = causal_mask_bias(t, attention_mask, None, device=h.device)
    local_bias = causal_mask_bias(t, attention_mask, config.sliding_window, device=h.device)
    states = [h]
    local = _local_config(model, config)
    for layer, is_global, base in zip(_layers(model), *_layer_schedule(config)):
        h = _layer(layer, h, full_bias if is_global else local_bias, positions, local, base)
        states.append(h)
    states[-1] = gemma_rms_norm(model.norm.weight, h, config.rms_norm_eps)
    return states


# Rows of the embedding table cast to fp32 at a time when the head has no
# fp32 copy: 32768 x 3840 x 4 bytes = 0.5 GB at the 12B's width.
HEAD_CHUNK = 32768


def _head(h: torch.Tensor, table: torch.Tensor, fp32_table: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32 logits h @ table^T: from ``fp32_table`` when given, else over
    vocabulary chunks of ``table`` cast to fp32 one at a time."""
    hf = h.float()
    if fp32_table is not None:
        return hf @ fp32_table.T
    return torch.cat([hf @ table[i:i + HEAD_CHUNK].float().T for i in range(0, table.shape[0], HEAD_CHUNK)], -1)


def gemma3_logits(
    model: Gemma3Model,
    config: Gemma3TextConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    kv_caches: Optional[List[KVCache]] = None,
    position_offset: int = 0,
    last_only: bool = False,
    fp32_table: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[List[KVCache]]]:
    """Forward to fp32 logits (B, T or 1, vocab) over the tied embedding head,
    optionally with KV caches (returned with their offsets advanced; their
    buffers are written in place). Positions start at ``position_offset``.
    With caches, ``attention_mask`` is (B, max_len): queries see the cached
    keys at or before them (within the sliding window on local layers), and
    -1e9 lands on masked keys. ``last_only`` computes the last position's
    logits alone. ``fp32_table``: the embedding table already in fp32 (else
    the head casts it a vocabulary chunk at a time)."""
    b, t = input_ids.shape
    dtype = model.embed_tokens.weight.dtype
    table = _table(model) if fp32_table is None else None
    # the fp32 copy's rows cast back are the table's rows exactly
    h = table[input_ids] if fp32_table is None else fp32_table[input_ids].to(dtype)
    h = h * torch.tensor(config.hidden_size**0.5, dtype=h.dtype)
    positions = position_offset + torch.arange(t, device=h.device)[None].expand(b, t)
    if kv_caches is None:
        full_bias = causal_mask_bias(t, attention_mask, None, device=h.device)
        local_bias = causal_mask_bias(t, attention_mask, config.sliding_window, device=h.device)
    else:
        max_len, offset = kv_caches[0].k.shape[2], kv_caches[0].offset
        ki = torch.arange(max_len, device=h.device)[None, :]
        qi = offset + torch.arange(t, device=h.device)[:, None]
        allowed = ki <= qi
        full_bias = torch.where(allowed, 0.0, -1e9).float()[None, None]
        local_bias = torch.where(allowed & (qi - ki < config.sliding_window), 0.0, -1e9).float()[None, None]
        if attention_mask is not None:
            pad = torch.where(attention_mask.bool(), 0.0, -1e9).float()[:, None, None, :]
            full_bias, local_bias = full_bias + pad, local_bias + pad
    caches = kv_caches if kv_caches is not None else [None] * config.num_hidden_layers
    local = _local_config(model, config)
    for layer, is_global, base, cache in zip(_layers(model), *_layer_schedule(config), caches):
        h = _layer(layer, h, full_bias if is_global else local_bias, positions, local, base, cache)
    if kv_caches is not None:
        for cache in kv_caches:
            cache.offset += t
    h = gemma_rms_norm(model.norm.weight, h, config.rms_norm_eps)
    if last_only:
        h = h[:, -1:]
    return _head(h, table, fp32_table), kv_caches


def init_kv_caches(config: Gemma3TextConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> List[KVCache]:
    """Zeroed full ``max_len`` key and value buffers for every layer (of
    ``config``'s key/value heads: a sharded model's local ones in
    :func:`generate`)."""
    shape = (batch, config.num_key_value_heads, max_len, config.head_dim)
    return [KVCache(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(config.num_hidden_layers)]


def top_p_filter(scaled: torch.Tensor, top_p: float) -> torch.Tensor:
    """-inf on the logits (1, vocab) below the top-p cutoff: the smallest
    logit of the shortest descending prefix whose softmax mass reaches
    ``top_p`` (the JAX function's cutoff)."""
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff = sorted_logits[0, int((cum < top_p).sum(dim=-1)[0])]
    return torch.where(scaled < cutoff, float("-inf"), scaled)


@torch.no_grad()
def generate(
    model: Gemma3Model,
    config: Gemma3TextConfig,
    input_ids,
    max_new_tokens: int = 512,
    temperature: float = 0.7,
    top_p: float = 1.0,
    eos_token_ids: Sequence[int] = (1, 106),
    generator: Optional[torch.Generator] = None,
) -> List[int]:
    """KV-cached autoregressive generation from one prompt's ids (1, T):
    greedy at ``temperature <= 0``, else a draw from ``generator`` (default:
    seeded 0 on the model's device) over softmax(logits / temperature) after
    the top-p cutoff. Stops at an id of ``eos_token_ids`` (not returned) or
    after ``max_new_tokens``; returns the new ids."""
    table = model.embed_tokens.weight
    device = table.device
    ids = torch.as_tensor(input_ids, device=device).long()
    b, prompt_len = ids.shape
    if b != 1:
        raise ValueError("generation is single-prompt")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    max_len = prompt_len + max_new_tokens
    caches = init_kv_caches(_local_config(model, config), b, max_len, dtype=table.dtype, device=device)
    mask = torch.zeros((b, max_len), dtype=torch.int32, device=device)
    mask[:, :prompt_len] = 1
    fp32_table = _table(model).float()  # one fp32 copy of the (whole) head a call
    logits, caches = gemma3_logits(model, config, ids, mask, caches, 0, last_only=True, fp32_table=fp32_table)
    out: List[int] = []
    pos = prompt_len
    for _ in range(max_new_tokens):
        next_logits = logits[:, -1]
        if temperature <= 0:
            picked = torch.argmax(next_logits, dim=-1, keepdim=True)
        else:
            scaled = next_logits / temperature
            if top_p < 1.0:
                scaled = top_p_filter(scaled, top_p)
            probs = torch.softmax(scaled, dim=-1).to(generator.device)
            picked = torch.multinomial(probs, 1, generator=generator).to(device)
        token = int(picked[0, 0])  # the one read-back a token: the eos check needs it
        if token in eos_token_ids:
            break
        out.append(token)
        mask[:, pos] = 1
        logits, caches = gemma3_logits(model, config, picked, mask, caches, pos, last_only=True,
                                       fp32_table=fp32_table)
        pos += 1
    return out
