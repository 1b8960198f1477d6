"""Scaled dot-product attention over (B, S, H, D) tensors.

Counterpart of mlx_video_tpu/ops/attention.py. Self-attention with no bias
goes to the flash kernel (ops/flash_attention.py): on a CUDA tensor that is
the CUDA kernel, on a CPU tensor its plain fp32 version. Everything else,
such as the text cross-attention with its caption bias, is plain torch:
matmul, fp32 softmax, matmul, as the XLA path of the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from mlx_video_tpu_torch.ops.flash_attention import flash_attention


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """fp32 logits (+ additive bias), fp32 softmax, probabilities cast to
    v's dtype for the second product (jax.nn.dot_product_attention's XLA
    path). bias broadcasts against (B, H, Sq, Skv)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over (B, S, H, D) tensors with an optional additive bias.

    Returns (B, Sq, H, D) in the input dtype.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias is None and q.shape[1] == k.shape[1]:
        return flash_attention(q, k, v, scale=scale)
    return plain_attention(q, k, v, bias, scale)


def sdpa_flat(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over flattened (B, S, H*D) tensors, on top of :func:`sdpa`."""
    b, sq, dim = q.shape
    skv = k.shape[1]
    d_head = dim // heads
    out = sdpa(
        q.reshape(b, sq, heads, d_head),
        k.reshape(b, skv, heads, d_head),
        v.reshape(b, skv, heads, d_head),
        bias=bias,
    )
    return out.reshape(b, sq, dim)
