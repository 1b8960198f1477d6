"""Gemma-3 text model: the hidden states the LTX-2 text encoder reads.

Counterpart of mlx_video_tpu/models/gemma3.py (``Gemma3TextConfig``,
``gemma_rms_norm``, ``_rope_neox``, ``_attention``, ``causal_mask_bias``,
``_layer_schedule``, ``gemma3_hidden_states``), plain PyTorch as it is plain
XLA there:

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
is (vocab, hidden) in both. Logits, the KV cache and generation (prompt
enhancement) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

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
    inv_freq = 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32, device=x.device), exponent)
    angles = positions.float()[:, None, :, None] * inv_freq[None, None, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _attention(attn: GemmaAttention, x: torch.Tensor, mask_bias: torch.Tensor, positions: torch.Tensor,
               config: Gemma3TextConfig, rope_base: float) -> torch.Tensor:
    b, t, _ = x.shape
    nh, nkv, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    q = linear(attn.q_proj, x).reshape(b, t, nh, hd).transpose(1, 2)
    k = linear(attn.k_proj, x).reshape(b, t, nkv, hd).transpose(1, 2)
    v = linear(attn.v_proj, x).reshape(b, t, nkv, hd).transpose(1, 2)
    q = _rope_neox(gemma_rms_norm(attn.q_norm.weight, q, config.rms_norm_eps), positions, rope_base)
    k = _rope_neox(gemma_rms_norm(attn.k_norm.weight, k, config.rms_norm_eps), positions, rope_base)
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
           config: Gemma3TextConfig, rope_base: float) -> torch.Tensor:
    eps = config.rms_norm_eps
    attn_out = _attention(layer.self_attn, gemma_rms_norm(layer.input_layernorm.weight, x, eps), mask_bias,
                          positions, config, rope_base)
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
    h = model.embed_tokens.weight[input_ids]
    h = h * torch.tensor(config.hidden_size**0.5, dtype=h.dtype)
    positions = torch.arange(t, device=h.device)[None].expand(b, t)
    full_bias = causal_mask_bias(t, attention_mask, None, device=h.device)
    local_bias = causal_mask_bias(t, attention_mask, config.sliding_window, device=h.device)
    states = [h]
    for layer, is_global, base in zip(model.layers, *_layer_schedule(config)):
        h = _layer(layer, h, full_bias if is_global else local_bias, positions, config, base)
        states.append(h)
    states[-1] = gemma_rms_norm(model.norm.weight, h, config.rms_norm_eps)
    return states
