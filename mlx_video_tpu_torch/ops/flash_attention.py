"""Flash-attention forward for the DiT self-attention: a CUDA kernel for Hopper.

Replaces ``mlx_video_tpu/ops/flash_attention.py:_flash_attention_impl`` (the
Pallas kernels ``_single_pass_kernel`` and ``_flash_kernel``). The kernel is
``mlx_video_tpu_torch/csrc/flash_attention_fwd.cu``, built by ``nvcc`` at
first use (ops/_build.py) and called through ``ctypes``.

What bounds it on the H100: at the DiT's shapes (B=1, H=32, D=128, S=320 to
5184) attention does 4*S*S*D*H operations on 4*S*H*D*2 bytes of q, k, v and
o, some S/2 operations per byte, far above the card's ~295 bf16 operations
per byte, so it is bound by tensor-core issue rate and the softmax's
exponentials, not by device memory.

What the design does about it: q, k and v are read in place through their
strides, so no transpose or pad copy runs first; K/V tiles of 64 rows sit in
shared memory while 4 warps of one block each keep 16 query rows, the
running max, sum and fp32 accumulator in registers; both products run on the
tensor cores as bf16 ``mma.sync`` with fp32 accumulation, and P never leaves
the registers. The softmax is exact at every length: unlike the Pallas
single-pass body, no logit clamp. ``wgmma``, TMA and warp specialisation are
left for later.

On a CPU tensor the wrapper computes :func:`flash_attention_reference`, the
plain fp32 version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from mlx_video_tpu_torch.ops import _build

# Kernel launches so far; a run resets it to 0 and reads it to show that its
# attention went through the kernel. Only a launch adds to it.
launch_count = 0

SUPPORTED_HEAD_DIMS = (64, 128)
_MAX_GRID_Y = 65535

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load_library()
        fn = lib.mvt_flash_attention_fwd_bf16
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 9
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.mvt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mvt_cuda_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Exact softmax(scale * q k^T) v in fp32 over (B, S, H, D) tensors.

    Returns the output in q's dtype and, with ``return_lse``, the per-row
    logsumexp as (B, H, S) fp32.
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the flash kernel takes bfloat16, {name} is {t.dtype}")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"{name} must be (B, S, H, D) like q {tuple(q.shape)}, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
        if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned with strides divisible by 8")
    b, s, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (kernel takes {SUPPORTED_HEAD_DIMS})")
    if s < 1 or b * h > _MAX_GRID_Y:
        raise ValueError(f"unsupported shape {tuple(q.shape)}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Bidirectional attention over (B, S, H, D): output (B, S, H, D) in the
    input dtype, and with ``return_lse`` the logsumexp (B, H, S) fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global launch_count
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    _check_operands(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, s, h, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = _build.load_library().mvt_cuda_error_string(err).decode()
        raise RuntimeError(f"flash attention kernel launch failed: {msg} ({err})")
    launch_count += 1
    return (out, lse) if return_lse else out
