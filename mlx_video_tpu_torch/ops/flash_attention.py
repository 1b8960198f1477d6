"""Flash attention for the DiT self-attention: CUDA kernels for Hopper, forward
(plain and with split RoPE fused in) and backward.

Forward (K1) replaces ``mlx_video_tpu/ops/flash_attention.py:_flash_attention_impl``
(the Pallas kernels ``_single_pass_kernel`` and ``_flash_kernel``); its kernel
is ``mlx_video_tpu_torch/csrc/flash_attention_fwd.cu``. Backward (K3) replaces
``_flash_attention_bwd_impl`` (``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel``); its kernels are
``mlx_video_tpu_torch/csrc/flash_attention_bwd.cu``. The forward with fused
split RoPE (K5) replaces ``_flash_attention_split_rope_impl`` (the Pallas
kernel ``_flash_rope_kernel``); its kernel is
``mlx_video_tpu_torch/csrc/flash_attention_rope.cu``: one pass that rotates q
and k in fp32 exactly as :func:`rotate_split` does, then K1's kernel on the
rotated tensors.
The int8 attention (K6) replaces ``flash_attention_int8`` (the Pallas kernel
``_single_pass_int8_kernel``); its kernel is
``mlx_video_tpu_torch/csrc/flash_attention_int8.cu``: int8 products on
``wgmma`` over TMA-fed tiles and an exact two-pass softmax over the keys,
behind JAX's quantization prologue as two exact CUDA passes
(:func:`int8_attention_prologue`). All are built by ``nvcc`` at first use
(ops/_build.py) and called through ``ctypes``.

What bounds them on the H100: at the DiT's shapes (B=1, H=32, D=128, S=320 to
5184) the forward does 4*S*S*D*H operations on 4*S*H*D*2 bytes of q, k, v and
o, and the backward 14*S*S*D*H on twice the bytes: some S/2 operations per
byte, far above the card's ~295 bf16 operations per byte, so both are bound
by tensor-core issue rate and the softmax's exponentials, not by device
memory.

What the design does about it: q, k and v are read in place through their
strides, so no transpose or pad copy runs first. K1 runs both products as
Hopper's ``wgmma`` (bf16 in, fp32 accumulation) for 128 query rows a block in
two warpgroups, with Q and 128-key K/V tiles brought into 128-byte swizzled
shared memory by TMA through a two-stage ring, so the next tile's copy
overlaps this tile's products; P never leaves the registers. The softmax is
exact at every length: unlike the Pallas single-pass body, no logit clamp.
K3 follows the same design: a dq kernel over 128 query rows and a dkv kernel
over 128 keys, each in two warpgroups, every product on ``wgmma``, 64-row
tiles by TMA through a two-stage ring, p and dS kept in registers; the two
kernels use no atomics (csrc/flash_attention_bwd.cu says how they split the
work), so its gradients are bitwise repeatable. K5 reads q, k and the tables
once in its rotation pass and then runs K1 unchanged, so its o and lse are
K1's on the plainly rotated q and k, bit for bit.

:func:`flash_attention` is differentiable: when q, k or v needs a gradient
the forward also keeps the logsumexp and the backward runs K3, as the JAX
``flash_attention`` custom VJP does. On CUDA K3 takes every length (the JAX
package's length threshold and VMEM limit are TPU matters).
:func:`flash_attention_split_rope` is differentiable the same way: its
backward is K3 on the rotated q and k, rotated back. On a CPU tensor every
entry point computes its plain fp32 version (:func:`flash_attention_reference`,
:func:`flash_attention_bwd_reference`,
:func:`flash_attention_split_rope_reference`) at any head dimension; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import torch

from mlx_video_tpu_torch.ops import _build
from mlx_video_tpu_torch.ops.int8 import int8_mm, scale_from_absmax

# Kernel launches so far: K1 (forward), K3 (backward; one count per backward,
# which launches its dq and its dkv kernel), K5 (forward with split RoPE), K6
# (int8 attention) and K6's prologue (one count per prologue, which launches
# its absmax and its quantize kernel). A run resets them to 0 and reads them
# to show that its attention went through the kernels. Only a launch adds to
# them.
launch_count = 0
bwd_launch_count = 0
rope_launch_count = 0
int8_launch_count = 0
int8_prologue_launch_count = 0

SUPPORTED_HEAD_DIMS = (64, 128)
_MAX_GRID_Y = 65535

_ARGTYPES = {
    "mvt_flash_attention_fwd_bf16": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p]
    ),
    "mvt_flash_attention_bwd_bf16": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    ),
    "mvt_flash_attention_rope_bf16": (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    ),
    "mvt_rope_rotate_bf16": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
    "mvt_flash_cross_attention_bf16": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    ),
    "mvt_flash_attention_int8": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "mvt_int8_attention_operands": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_void_p] * 7
    ),
}
_fns = {}


def _kernel(name: str = "mvt_flash_attention_fwd_bf16"):
    """The C entry point ``name`` of the kernel library, built and bound at
    first use."""
    if name not in _fns:
        lib = _build.load_library()
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        lib.mvt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mvt_cuda_error_string.restype = ctypes.c_char_p
        _fns[name] = fn
    return _fns[name]


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


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain fp32 flash backward over (B, S, H, D) tensors and the forward's
    (B, H, S) logsumexp: p = exp(scale q k^T - lse), dp = dO v^T,
    D = rowsum(dO * o), dS = p (dp - D) scale; returns dQ = dS k,
    dK = dS^T q and dV = p^T dO in the dtypes of q, k and v."""
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    rowdot = (dof * of).sum(-1).transpose(1, 2)  # (B, H, S)
    ds = p * (dp - rowdot[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **others: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), *others.items()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the flash kernel takes bfloat16, {name} is {t.dtype}")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"{name} must be (B, S, H, D) like q {tuple(q.shape)}, got {tuple(t.shape)}")
        if not _readable_in_place(t):
            raise ValueError(f"{name} must have a contiguous last dimension, be 16-byte aligned "
                             "and have strides divisible by 8")
    b, s, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (kernel takes {SUPPORTED_HEAD_DIMS})")
    if s < 1 or b * h > _MAX_GRID_Y:
        raise ValueError(f"unsupported shape {tuple(q.shape)}")


def _readable_in_place(t: torch.Tensor) -> bool:
    """The kernels read 16-byte rows through the strides of the first three
    dimensions."""
    return t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:3]) and t.data_ptr() % 16 == 0


def _raise_launch_error(what: str, err: int) -> None:
    msg = _build.load_library().mvt_cuda_error_string(err).decode()
    raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _flash_forward(q, k, v, scale: float, return_lse: bool):
    """K1 on CUDA tensors, the plain version on CPU tensors."""
    global launch_count
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
        _raise_launch_error("flash attention", err)
    launch_count += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK, dV of attention from the forward's output ``o`` and logsumexp
    ``lse`` (B, H, S) fp32 and the output gradient ``do``, all (B, S, H, D).
    ``o`` and ``lse`` may be those of a longer attention of which ``k`` and
    ``v`` are one key block of q's length (the ring backward,
    parallel/ring_attention.py): p = exp(scale q k^T - lse) and D =
    rowsum(dO o) are then the whole attention's, and the gradients this
    block's share (dK, dV whole for the block; dQ a term of the sum).

    CPU tensors take :func:`flash_attention_bwd_reference`; CUDA tensors
    launch K3 (bf16; a ``do`` the kernel cannot read in place is copied
    contiguous first) or raise.
    """
    global bwd_launch_count
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CUDA or CPU tensors, got {q.device}")
    if do.dim() == 4 and not _readable_in_place(do):
        do = do.contiguous()
    _check_operands(q, k, v, o=o, do=do)
    b, s, h, d = q.shape
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous ({b}, {h}, {s}) fp32 tensor on {q.device}, "
                         f"got {tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    rowdot = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 15)(*(st for t in (q, k, v, o, do) for st in t.stride()[:3]))
    fn = _kernel("mvt_flash_attention_bwd_bf16")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), rowdot.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, d, strides, float(scale), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        _raise_launch_error("flash attention backward", err)
    bwd_launch_count += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX ``flash_attention`` custom VJP: the forward keeps q, k, v, the
    output and its logsumexp; the backward is :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, lse = _flash_forward(q, k, v, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Bidirectional attention over (B, S, H, D): output (B, S, H, D) in the
    input dtype, and with ``return_lse`` the logsumexp (B, H, S) fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel. When
    gradients are on and q, k or v needs one, the output is differentiable
    through K3 (``return_lse`` output is not differentiable).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not return_lse and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, scale)
    return _flash_forward(q, k, v, scale, return_lse)


# ---------------------------------------------------------------------------
# K5: flash attention with split RoPE fused in
# ---------------------------------------------------------------------------


def rotate_split(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Split RoPE of (B, S, H, D) ``x`` by (B, H, S, D/2) tables in fp32,
    returned in x's dtype: [x1 cos - sin x2, x2 cos + sin x1], the DiT's
    rotation (models/ltx/rope.py:apply_split_rotary_emb calls this) and K5's.
    ``inverse`` applies the transpose (sin negated), which takes a gradient
    of the rotated tensor back to the unrotated one."""
    first, second = x.float().chunk(2, dim=-1)
    c, s = cos.float().transpose(1, 2), sin.float().transpose(1, 2)
    if inverse:
        out = torch.cat([first * c + s * second, second * c - s * first], dim=-1)
    else:
        out = torch.cat([first * c - s * second, second * c + s * first], dim=-1)
    return out.to(x.dtype)


def flash_attention_split_rope_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    scale: float,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q and k rotated in fp32 and cast back (:func:`rotate_split`), then
    :func:`flash_attention_reference` (JAX ``_xla_split_rope_attention``)."""
    return flash_attention_reference(
        rotate_split(q, cos, sin), rotate_split(k, cos, sin), v, scale, return_lse
    )


def _check_tables(q: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> None:
    b, s, h, d = q.shape
    for name, t in (("cos", cos), ("sin", sin)):
        if t.device != q.device or t.dtype != torch.float32 or tuple(t.shape) != (b, h, s, d // 2):
            raise ValueError(f"{name} must be a ({b}, {h}, {s}, {d // 2}) fp32 table on {q.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if t.stride(-1) != 1 or any(st % 4 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} must have a contiguous last dimension, be 16-byte aligned "
                             "and have strides divisible by 4")


def rope_rotate(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's rotation pass alone: ``(rotate_split(q, cos, sin),
    rotate_split(k, cos, sin))`` as contiguous (B, S, H, D) tensors.

    CPU tensors take :func:`rotate_split`; CUDA tensors launch the rotation
    kernel of K5 (bf16, D in {64, 128}) or raise. It is the first half of a
    K5 call, exposed so that a check can hold it against the plain rotation;
    no path calls it, and it adds to no launch count.
    """
    if q.device.type == "cpu":
        return rotate_split(q, cos, sin), rotate_split(k, cos, sin)
    if q.device.type != "cuda":
        raise ValueError(f"rope_rotate runs on CUDA or CPU tensors, got {q.device}")
    _check_operands(q, k, k)
    _check_tables(q, cos, sin)
    b, s, h, d = q.shape
    qr, kr = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device) for _ in range(2))
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, cos, sin) for st in t.stride()[:3]))
    fn = _kernel("mvt_rope_rotate_bf16")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(), qr.data_ptr(), kr.data_ptr(),
            b, s, h, d, strides, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        _raise_launch_error("split RoPE rotation", err)
    return qr, kr


def _rope_forward(q, k, v, cos, sin, scale: float, return_lse: bool):
    """K5 on CUDA tensors (the rotation pass into two workspaces, then K1's
    kernel on them: one launch count, on ``rope_launch_count``), the plain
    version on CPU tensors."""
    global rope_launch_count
    if q.device.type == "cpu":
        return flash_attention_split_rope_reference(q, k, v, cos, sin, scale, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_split_rope runs on CUDA or CPU tensors, got {q.device}")
    _check_operands(q, k, v)
    _check_tables(q, cos, sin)
    b, s, h, d = q.shape
    qr, kr, out = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    strides = (ctypes.c_longlong * 15)(*(st for t in (q, k, v) for st in t.stride()[:3]),
                                       *(st for t in (cos, sin) for st in t.stride()[:3]))
    fn = _kernel("mvt_flash_attention_rope_bf16")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(), qr.data_ptr(),
            kr.data_ptr(), out.data_ptr(), lse.data_ptr() if lse is not None else None,
            b, s, h, d, strides, float(scale), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        _raise_launch_error("flash attention with split RoPE", err)
    rope_launch_count += 1
    return (out, lse) if return_lse else out


class _FlashAttentionSplitRope(torch.autograd.Function):
    """The JAX ``flash_attention_split_rope`` custom VJP without its S x S
    recompute: the forward is K5 with lse; the backward rotates q and k with
    the plain rotation, runs K3 on the rotated tensors, the output and the
    lse, and rotates dq and dk back by the transpose of the rotation. The
    tables get no gradient (the JAX VJP returns one; the DiT never needs it)."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, scale: float):
        out, lse = _rope_forward(q, k, v, cos, sin, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, cos, sin, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, cos, sin, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            rotate_split(q, cos, sin), rotate_split(k, cos, sin), v, out, lse, do, ctx.scale
        )
        return rotate_split(dq, cos, sin, inverse=True), rotate_split(dk, cos, sin, inverse=True), dv, None, None, None


def flash_attention_split_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    scale: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Bidirectional attention over (B, S, H, D) with q and k rotated by the
    (B, H, S, D/2) split-RoPE tables; output (B, S, H, D) in the input dtype
    and, with ``return_lse``, the logsumexp (B, H, S) fp32.

    CPU tensors take the plain version at any head dimension; CUDA tensors
    launch K5 (bf16, D in {64, 128}, fp32 tables read through their strides)
    or raise. Differentiable in q, k and v (K3 in the backward); tables that
    require a gradient are refused.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (cos.requires_grad or sin.requires_grad):
        raise ValueError("flash_attention_split_rope computes no gradient for the RoPE tables")
    if not return_lse and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttentionSplitRope.apply(q, k, v, cos, sin, scale)
    return _rope_forward(q, k, v, cos, sin, scale, return_lse)


# ---------------------------------------------------------------------------
# K6: int8 single-pass attention
# ---------------------------------------------------------------------------

# The prologue pads S to a multiple; K6's 128-row tiles read past it as TMA's zeros.
INT8_BLOCK = 64


class Int8Operands(NamedTuple):
    """The quantization prologue's output, K6's operands: codes padded with
    zeros to ``s_pad`` rows (a multiple of 64), head-major."""

    q: torch.Tensor  # (B*H, S_pad, D) int8, one per-tensor scale
    k: torch.Tensor  # (B*H, S_pad, D) int8, one per-tensor scale
    v_t: torch.Tensor  # (B*H, D, S_pad) int8, v's codes transposed
    qk_scale: torch.Tensor  # () fp32: s_q * s_k * softmax scale
    v_scale: torch.Tensor  # (B*H, D) fp32, per (head, channel)
    s: int  # the sequence length before padding


def _quant_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 codes of fp32 ``x`` and their scale."""
    sc = scale_from_absmax(x.abs().amax())
    return torch.clamp(torch.round(x / sc), -127, 127).to(torch.int8), sc


def int8_attention_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> Int8Operands:
    """The JAX ``flash_attention_int8`` prologue (XLA there, plain PyTorch
    here) on (B, S, H, D) tensors: q and k quantized per tensor (one absmax
    over all heads), v per (batch * head, channel) with the absmax over
    tokens; codes clip(round(x / sc), -127, 127) with sc = max(absmax / 127,
    1e-12), rounding half to even. Padding rows are zero codes, which change
    no absmax."""
    b, s, h, d = q.shape
    s_pad = -(-s // INT8_BLOCK) * INT8_BLOCK

    def heads(x):
        return x.float().permute(0, 2, 1, 3).reshape(b * h, s, d)

    def padded(codes):
        out = torch.zeros((b * h, s_pad, d), dtype=torch.int8, device=q.device)
        out[:, :s] = codes
        return out

    q_q, s_q = _quant_tensor(heads(q))
    k_q, s_k = _quant_tensor(heads(k))
    v32 = heads(v)
    v_sc = scale_from_absmax(v32.abs().amax(dim=1, keepdim=True))  # (B*H, 1, D)
    v_q = torch.clamp(torch.round(v32 / v_sc), -127, 127).to(torch.int8)
    v_t = torch.zeros((b * h, d, s_pad), dtype=torch.int8, device=q.device)
    v_t[:, :, :s] = v_q.transpose(1, 2)
    return Int8Operands(padded(q_q), padded(k_q), v_t, (s_q * s_k * scale).float(), v_sc[:, 0].contiguous(), s)


def flash_attention_int8_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    return_codes: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """K6's plain version, one (batch, head) at a time: the prologue, then
    logits = fp32(int32(q_q k_q^T)) * qk_scale with keys past S at -inf,
    p_q = round(127 exp(logits - max)) as int8, l = max(sum p_q, 1) and
    out = fp32(int32(p_q v_q)) * v_scale / l in q's dtype. Both products are
    exact integer products (ops/int8.py:int8_mm), never fp32 sums. With
    ``return_codes`` also p_q as a (B*H, S, S) int8 tensor."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, s, h, d = q.shape
    ops = int8_attention_operands(q, k, v, scale)
    s_pad = ops.q.shape[1]
    keep = torch.arange(s_pad, device=q.device) < s
    out = torch.empty((b * h, s, d), dtype=torch.float32, device=q.device)
    codes = torch.empty((b * h, s, s), dtype=torch.int8, device=q.device) if return_codes else None
    for i in range(b * h):
        logits = int8_mm(ops.q[i], ops.k[i]).float() * ops.qk_scale
        logits = torch.where(keep, logits, -torch.inf)
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        p_q = torch.round(p * 127.0).to(torch.int8)
        l = torch.clamp(p_q.float().sum(dim=-1, keepdim=True), min=1.0)
        acc = int8_mm(p_q, ops.v_t[i])
        out[i] = (acc.float() * ops.v_scale[i] / l)[:s]
        if codes is not None:
            codes[i] = p_q[:s, :s]
    out = out.reshape(b, h, s, d).permute(0, 2, 1, 3).to(q.dtype)
    return (out, codes) if return_codes else out


def _check_int8_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on (B, S, H, D) inputs that the CUDA prologue and K6 do not take."""
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must be (B, S, H, D) {q.dtype} like q {tuple(q.shape)} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if q.dim() != 4 or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the int8 attention kernel takes (B, S, H, D) bf16 or fp32, got {tuple(q.shape)} {q.dtype}")
    b, s, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (kernel takes {SUPPORTED_HEAD_DIMS})")
    if s < 1 or b * h > _MAX_GRID_Y:
        raise ValueError(f"unsupported shape {tuple(q.shape)}")


def _reads_16_bytes(*ts: torch.Tensor) -> bool:
    """Whether the prologue can read every tensor 16 bytes at a time: unit
    channel stride, other strides whole 16-byte steps, 16-byte aligned."""
    per = 16 // ts[0].element_size()
    return all(t.stride(-1) == 1 and not any(st % per for st in t.stride()[:3]) and t.data_ptr() % 16 == 0
               for t in ts)


def int8_attention_prologue(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> Int8Operands:
    """K6's quantization prologue, :func:`int8_attention_operands` as two CUDA
    passes: one reads q, k and v through their strides for |q|max, |k|max and
    v's per-(batch * head, channel) absmax; the other writes the codes with
    their zero padding and the scales. Its operands equal the plain
    version's bit for bit.

    CPU tensors take :func:`int8_attention_operands`; CUDA tensors (bf16 or
    fp32, all three alike, D in {64, 128}) launch the two kernels or raise.
    Each CUDA call adds one to ``int8_prologue_launch_count``."""
    global int8_prologue_launch_count
    if q.device.type == "cpu":
        return int8_attention_operands(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"int8_attention_prologue runs on CUDA or CPU tensors, got {q.device}")
    _check_int8_inputs(q, k, v)
    b, s, h, d = q.shape
    s_pad = -(-s // INT8_BLOCK) * INT8_BLOCK
    dev, n = q.device, b * h * s_pad * d
    codes = torch.empty(3 * n, dtype=torch.int8, device=dev)
    q_q, k_q = codes[:n].view(b * h, s_pad, d), codes[n:2 * n].view(b * h, s_pad, d)
    v_t = codes[2 * n:].view(b * h, d, s_pad)
    scales = torch.empty(3 + 2 * b * h * d, dtype=torch.float32, device=dev)
    qk_scale, v_scale = scales[0], scales[1:1 + b * h * d].view(b * h, d)
    amax = scales[1 + b * h * d:]  # the absmax pass's scratch
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v) for st in t.stride()))
    fn = _kernel("mvt_int8_attention_operands")
    with torch.cuda.device(dev):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), strides, b, s, h, d, s_pad,
            int(q.dtype == torch.float32), int(_reads_16_bytes(q, k, v)), float(scale),
            q_q.data_ptr(), k_q.data_ptr(), v_t.data_ptr(), qk_scale.data_ptr(), v_scale.data_ptr(),
            amax.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        _raise_launch_error("int8 attention prologue", err)
    int8_prologue_launch_count += 1
    return Int8Operands(q_q, k_q, v_t, qk_scale, v_scale, s)


def flash_attention_int8(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    return_codes: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Bidirectional attention over (B, S, H, D) with int8 products: the JAX
    ``flash_attention_int8``. Output (B, S, H, D) in q's dtype.

    CPU tensors take :func:`flash_attention_int8_reference`; CUDA tensors run
    the CUDA prologue (:func:`int8_attention_prologue`) and launch K6 (D in
    {64, 128}, bf16 or fp32 q, k, v) or raise. Inference only, as in JAX (no
    VJP): an input that requires a gradient is refused. With
    ``return_codes`` K6 also writes its p_q codes as a (B*H, S, S) int8
    tensor, so a check can count those that differ from the plain
    version's."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention_int8 is inference only (no gradient, as in the JAX package)")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_int8_reference(q, k, v, scale, return_codes)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_int8 runs on CUDA or CPU tensors, got {q.device}")
    ops = int8_attention_prologue(q, k, v, scale)
    return int8_attention_kernel(ops, q.shape[0], q.shape[2], q.dtype, return_codes)


def int8_attention_kernel(
    ops: Int8Operands, b: int, h: int, out_dtype=torch.bfloat16, return_codes: bool = False
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """K6 alone on the prologue's operands (CUDA tensors, the plain or the
    CUDA prologue's): the (B, S, H, D) output in ``out_dtype`` (bf16 or
    fp32), and with ``return_codes`` p_q as (B*H, S, S) int8."""
    global int8_launch_count
    s, s_pad, d, dev = ops.s, ops.q.shape[1], ops.q.shape[2], ops.q.device
    if dev.type != "cuda":
        raise ValueError(f"int8_attention_kernel takes CUDA operands, got {dev}")
    for name, t, shape in (("q", ops.q, (b * h, s_pad, d)), ("k", ops.k, (b * h, s_pad, d)),
                           ("v_t", ops.v_t, (b * h, d, s_pad))):
        if t.device != dev or t.dtype != torch.int8 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"operand {name} must be a contiguous {shape} int8 tensor on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if d not in SUPPORTED_HEAD_DIMS or s_pad % INT8_BLOCK or not 1 <= s <= s_pad or out_dtype not in (
            torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported int8 operands: S={s}, S_pad={s_pad}, D={d}, output {out_dtype}")
    if ops.qk_scale.numel() != 1 or ops.v_scale.shape != (b * h, d) or not ops.v_scale.is_contiguous() or any(
            t.dtype != torch.float32 or t.device != dev for t in (ops.qk_scale, ops.v_scale)):
        raise ValueError(f"qk_scale must be one fp32 value and v_scale a contiguous (B*H, D) fp32 tensor on {dev}")
    out = torch.empty((b, s, h, d), dtype=out_dtype, device=dev)
    codes = torch.empty((b * h, s, s), dtype=torch.int8, device=dev) if return_codes else None
    fn = _kernel("mvt_flash_attention_int8")
    with torch.cuda.device(dev):
        err = fn(
            ops.q.data_ptr(), ops.k.data_ptr(), ops.v_t.data_ptr(), ops.qk_scale.data_ptr(),
            ops.v_scale.data_ptr(), out.data_ptr(), codes.data_ptr() if codes is not None else None,
            b, s, s_pad, h, d, int(out_dtype == torch.float32), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        _raise_launch_error("int8 attention", err)
    int8_launch_count += 1
    return (out, codes) if return_codes else out
