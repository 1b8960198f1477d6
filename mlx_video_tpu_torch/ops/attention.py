"""Scaled dot-product attention over (B, S, H, D) tensors, and its routes to
the kernels.

Counterpart of mlx_video_tpu/ops/attention.py. :func:`sdpa` keeps the JAX
order: self-attention with no bias goes to the flash kernel (K1,
ops/flash_attention.py); then, when the cross-attention route is on, a
cross-attention call (Sq != Skv, no bias or a per-key-only (B, 1, 1, Skv)
bias) goes to K4 (ops/cross_attention.py); everything else is
:func:`plain_attention` (matmul, fp32 softmax, matmul, as the XLA path of the
JAX package). :func:`sdpa_flat_fused_rope` takes a SPLIT-RoPE self-attention
to K5, which rotates q and k in one pass of its own and runs K1's kernel on
them.

The two routes are the JAX package's own opt-in switches, read at import from
the same environment variables and off by default:
``MLX_VIDEO_TPU_CROSS_KERNEL=1`` (K4) and ``MLX_VIDEO_TPU_FUSED_ROPE=1`` (K5);
:func:`use_cross_kernel` and :func:`use_fused_rope` set them in process.
The eligibility tests keep only the conditions that define the functions
(Sq != Skv and a per-key bias for K4; tables of shape (B, H, S, D/2) matching
q for K5) and drop the TPU layout conditions (KV in VMEM, S >= 256,
D % 128 == 0), as K1's route dropped the flash VMEM bound. Routing therefore
does not depend on the device: on a CPU tensor every kernel wrapper computes
its plain version at any head dimension, and on a CUDA tensor it launches
its kernel or raises on a head dimension the kernel does not take (it takes
64 and 128), so the CPU tests with tiny heads go down the card's routes.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from mlx_video_tpu_torch.ops.cross_attention import flash_cross_attention, plain_attention
from mlx_video_tpu_torch.ops.flash_attention import flash_attention, flash_attention_split_rope

_USE_CROSS_KERNEL: bool = os.environ.get("MLX_VIDEO_TPU_CROSS_KERNEL", "") == "1"
_USE_FUSED_ROPE: bool = os.environ.get("MLX_VIDEO_TPU_FUSED_ROPE", "") == "1"


def use_cross_kernel(enable: bool = True) -> None:
    """Route eligible text cross-attention to K4 (or not)."""
    global _USE_CROSS_KERNEL
    _USE_CROSS_KERNEL = enable


def use_fused_rope(enable: bool = True) -> None:
    """Route SPLIT-RoPE self-attention to K5 (or not)."""
    global _USE_FUSED_ROPE
    _USE_FUSED_ROPE = enable


def _cross_eligible(q: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor]) -> bool:
    """Cross-attention with no bias or a per-key-only (B, 1, 1, Skv) bias
    (the caption mask), with the route on."""
    return (
        _USE_CROSS_KERNEL
        and q.shape[1] != k.shape[1]
        and (bias is None or (bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1))
    )


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
    if _cross_eligible(q, k, bias):
        rows = None if bias is None else bias.reshape(bias.shape[0], bias.shape[-1])
        return flash_cross_attention(q, k, v, bias=rows, scale=scale)
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


def fused_split_rope_eligible(
    q: torch.Tensor, heads: int, pe: Optional[Tuple[torch.Tensor, torch.Tensor]]
) -> bool:
    """Whether K5 can take this self-attention: the route on and SPLIT
    (B, H, S, D/2) tables that match the flattened (B, S, H*D) q."""
    if not _USE_FUSED_ROPE or pe is None:
        return False
    b, s, dim = q.shape
    return pe[0].dim() == 4 and tuple(pe[0].shape) == (b, heads, s, dim // heads // 2)


def sdpa_flat_fused_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    pe: Tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """Self-attention over flattened (B, S, H*D) unrotated q and k, with the
    split RoPE applied by K5 (its rotation pass, then K1's kernel)."""
    b, s, dim = q.shape
    d_head = dim // heads
    out = flash_attention_split_rope(
        q.reshape(b, s, heads, d_head),
        k.reshape(b, s, heads, d_head),
        v.reshape(b, s, heads, d_head),
        pe[0], pe[1], scale=d_head**-0.5,
    )
    return out.reshape(b, s, dim)
