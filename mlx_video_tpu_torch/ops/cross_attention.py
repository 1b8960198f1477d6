"""Text cross-attention with a short key/value side: a CUDA kernel for Hopper
(K4) and the plain attention arithmetic it is held against.

K4 replaces ``mlx_video_tpu/ops/flash_attention.py:_flash_cross_attention_impl``
(the Pallas kernel ``_cross_kernel``); its kernel is
``mlx_video_tpu_torch/csrc/flash_cross_attention.cu``, built by ``nvcc`` at
first use (ops/_build.py) and called through ``ctypes``. It computes
softmax(scale * q k^T + bias[b, key]) v for (B, Sq, H, D) video queries and
(B, Skv, H, D) caption keys and values, with an optional (B, Skv) additive
per-key bias (the caption mask).

What bounds it on the H100: at the dev path's shape (B = 2, Sq = 5184,
Skv = 128, H = 32, D = 128) the work is reading q and writing o, 170 MB
(0.051 ms at 3.35 TB/s), against 1.4e10 operations (0.014 ms at the bf16
peak): device memory. The design reads each q row and writes each o row
once: for a caption of up to 128 keys a persistent grid keeps K, V and the
bias resident in shared memory while 128-row query tiles stream past by TMA
(``wgmma`` for both products, o out by TMA store); longer captions stream
128-key tiles with an exact online softmax, as K1 does. The bias is added in
fp32 before the row max; the csrc file says more.

On a CPU tensor :func:`flash_cross_attention` computes the plain version
(:func:`flash_cross_attention_reference`: fp32 logits and softmax, the
probabilities cast to v's dtype for the second product, as the JAX
package's XLA path), at any head dimension; on a CUDA tensor it launches the
kernel or raises. Its backward recomputes through the plain version under
autograd, as the JAX custom VJP (``_fca_bwd``) recomputes through XLA: there
is no backward kernel to port.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mlx_video_tpu_torch.ops import flash_attention as fa

# Launches of K4 so far. A run resets it to 0 and reads it to show that its
# cross-attention went through the kernel. Only a launch adds to it.
launch_count = 0


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


def flash_cross_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`plain_attention` with a (B, Skv) per-key bias row (or None)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias is not None:
        bias = bias[:, None, None, :]
    return plain_attention(q, k, v, bias, scale)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or (k.shape[0], k.shape[2], k.shape[3]) != (q.shape[0], q.shape[2], q.shape[3])):
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, Skv, H, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the cross-attention kernel takes bfloat16, {name} is {t.dtype}")
        if not fa._readable_in_place(t):
            raise ValueError(f"{name} must have a contiguous last dimension, be 16-byte aligned "
                             "and have strides divisible by 8")
    if d not in fa.SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (kernel takes {fa.SUPPORTED_HEAD_DIMS})")
    if sq < 1 or k.shape[1] < 1 or b * h > fa._MAX_GRID_Y:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    if bias is not None and (bias.dim() != 2 or bias.shape[0] not in (1, b) or bias.shape[1] != k.shape[1]
                             or bias.device != q.device):
        raise ValueError(f"bias must be ({b}, {k.shape[1]}) rows on {q.device}, got {tuple(bias.shape)}")


def _cross_forward(q, k, v, bias, scale: float) -> torch.Tensor:
    """K4 on CUDA tensors, the plain version on CPU tensors."""
    global launch_count
    if q.device.type == "cpu":
        return flash_cross_attention_reference(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_cross_attention runs on CUDA or CPU tensors, got {q.device}")
    _check(q, k, v, bias)
    b, sq, h, d = q.shape
    if bias is not None:
        bias = bias.to(torch.float32).expand(b, -1)
        if bias.stride(-1) != 1:
            bias = bias.contiguous()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 10)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       bias.stride(0) if bias is not None else 0)
    fn = fa._kernel("mvt_flash_cross_attention_bf16")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr() if bias is not None else None,
            out.data_ptr(), b, sq, k.shape[1], h, d, strides, float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        fa._raise_launch_error("cross attention", err)
    launch_count += 1
    return out


class _FlashCrossAttention(torch.autograd.Function):
    """The JAX ``flash_cross_attention`` custom VJP: the forward is the
    kernel; the backward recomputes the plain version under autograd."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale: float):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return _cross_forward(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        inputs = [t.detach().requires_grad_() for t in (q, k, v)]
        if bias is not None and ctx.needs_input_grad[3]:
            bias = bias.detach().requires_grad_()
            inputs.append(bias)
        with torch.enable_grad():
            out = flash_cross_attention_reference(*inputs[:3], bias, ctx.scale)
            grads = torch.autograd.grad(out, inputs, do)
        return (*grads[:3], grads[3] if len(grads) > 3 else None, None)


def flash_cross_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Cross-attention of (B, Sq, H, D) queries over (B, Skv, H, D) keys and
    values with an optional (B, Skv) additive per-key bias; returns
    (B, Sq, H, D) in q's dtype.

    CPU tensors take the plain version at any head dimension; CUDA tensors
    launch K4 (bf16, D in {64, 128}) or raise. When gradients are on and an
    input needs one, the output is differentiable (the backward recomputes
    through the plain version).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, bias)):
        return _FlashCrossAttention.apply(q, k, v, bias, scale)
    return _cross_forward(q, k, v, bias, scale)
