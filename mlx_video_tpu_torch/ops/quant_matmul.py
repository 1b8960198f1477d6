"""Dequantizing matmul for group-affine quantized linears: a CUDA kernel for Hopper.

Replaces ``mlx_video_tpu/ops/quant_matmul.py:quant_matmul`` (the Pallas
kernel ``_qmm_kernel``): y = x @ dequant(packed, scales, biases)^T with
w = q * scale + bias per group, computed in fp32, rounded to x's dtype, and
multiplied with fp32 accumulation. The kernel is
``mlx_video_tpu_torch/csrc/quant_matmul.cu``, built by ``nvcc`` at first use
(ops/_build.py) and called through ``ctypes``.

What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s: a ridge of ~295
operations per byte): a product reads K * N weights once for 2 * M * K * N
operations. Dense bf16 weights (2 bytes) give M operations per byte: bound
by weight bytes at M = 128, at the ridge at M = 320, by the tensor cores at
M = 1280. The plain version writes and reads back a bf16 copy (~4.6 bytes
per weight): bytes bound it at M = 128 and 320, the tensor cores at 1280.
Packed 4-bit words with group-64 fp32 scales are ~0.63 bytes per weight,
3.2 * M operations per byte, so at every M of the path the kernel's floor
is the tensor-core rate.

What the design does about it (the source's header note has the detail):
the operands are swapped, so a block computes a y^T tile of 128 weight rows
by up to 256 x rows with ``wgmma``, and each weight value is dequantized
once per tile of x rows; each warpgroup dequantizes its rows of a K step
into a bf16 tile in shared memory while the previous step's products run,
so no dequantized weight reaches device memory; x, the words and (where
their rows allow) the scales arrive by TMA, the rest by cp.async, through
one mbarrier ring; small M splits K over a thread-block cluster whose
blocks add their fp32 tiles through distributed shared memory in a fixed
order, so every call gives the same bits. Scales and biases are read in
their stored dtype (fp32, bf16 or fp16) and the affine is fp32, as in the
JAX package's default XLA path (not the Pallas kernel's bf16 scales).

On a CPU tensor the wrapper computes :func:`quant_matmul_reference`, the
plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from mlx_video_tpu_torch.ops import _build
from mlx_video_tpu_torch.ops.quant import dequantize_affine

# Kernel launches so far; a run resets it to 0 and reads it to show that its
# quantized linears went through the kernel. Only a launch adds to it.
launch_count = 0

KERNEL_BITS = (2, 4, 8)
_SCALE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BLOCK_N = 128
_MAX_GRID_Y = 65535

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load_library()
        fn = lib.mvt_quant_matmul_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mvt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mvt_cuda_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


def quant_matmul_reference(
    x: torch.Tensor,
    packed: torch.Tensor,
    scales: torch.Tensor,
    biases: torch.Tensor,
    bits: int,
    group_size: int,
) -> torch.Tensor:
    """Plain version: dequantize to x's dtype, then ``x @ w^T`` over (..., K)."""
    if x.shape[-1] // scales.shape[-1] != group_size:
        raise ValueError(f"scales {tuple(scales.shape)} do not give group {group_size} over K = {x.shape[-1]}")
    return x @ dequantize_affine(packed, scales, biases, bits=bits, dtype=x.dtype).T


def _check_operands(x, packed, scales, biases, bits: int, group_size: int) -> None:
    if bits not in KERNEL_BITS:
        raise ValueError(f"the dequantizing matmul takes bits {KERNEL_BITS}, got {bits}")
    if group_size < 1 or group_size % (32 // bits):
        raise ValueError(f"group_size {group_size} must hold whole {32 // bits}-value words")
    k = x.shape[-1]
    if k % group_size:
        raise ValueError(f"K = {k} is not divisible by group_size {group_size}")
    n = packed.shape[0]
    if packed.dim() != 2 or packed.shape[1] * 32 != k * bits:
        raise ValueError(f"packed {tuple(packed.shape)} does not hold ({n}, {k} x {bits} bits)")
    if packed.dtype != torch.int32:
        raise ValueError(f"packed words must be int32 (the uint32 bits), got {packed.dtype}")
    for name, t in (("scales", scales), ("biases", biases)):
        if t.shape != (n, k // group_size):
            raise ValueError(f"{name} {tuple(t.shape)} != ({n}, {k // group_size})")
        if t.dtype not in _SCALE_DTYPES or t.dtype != scales.dtype:
            raise ValueError(f"{name} must be fp32, bf16 or fp16 like scales, got {t.dtype}")


def quant_matmul(
    x: torch.Tensor,
    packed: torch.Tensor,
    scales: torch.Tensor,
    biases: torch.Tensor,
    bits: int,
    group_size: int,
) -> torch.Tensor:
    """y = x @ dequant(packed, scales, biases)^T over (..., K) activations.

    packed: (N, K*bits/32) int32; scales/biases: (N, K/group_size). Returns
    (..., N) in x's dtype. bits is 2, 4 or 8; group_size holds whole words
    (a multiple of 32 / bits) and divides K. CPU tensors take the plain
    version; CUDA tensors launch the kernel, which takes bf16 x with x's
    flattened (M, K) view contiguous and K a multiple of 8.
    """
    global launch_count
    _check_operands(x, packed, scales, biases, bits, group_size)
    if x.device.type == "cpu":
        return quant_matmul_reference(x, packed, scales, biases, bits, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on CUDA or CPU tensors, got {x.device}")
    *lead, k = x.shape
    n = packed.shape[0]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the dequantizing kernel takes bfloat16 x, got {x.dtype}")
    for name, t in (("x", x2), ("packed", packed), ("scales", scales), ("biases", biases)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (x as its flattened (M, K) view)")
    if x2.data_ptr() % 16 or packed.data_ptr() % 4:
        raise ValueError("x must be 16-byte aligned and packed 4-byte aligned")
    # The kernel copies scales and biases as 4-byte words; a 2-byte view that
    # starts between two words is copied once to a fresh allocation.
    scales = scales if scales.data_ptr() % 4 == 0 else scales.clone()
    biases = biases if biases.data_ptr() % 4 == 0 else biases.clone()
    if m == 0 or k % 8 or (n + _BLOCK_N - 1) // _BLOCK_N > _MAX_GRID_Y:
        raise ValueError(f"unsupported shape: M = {m}, K = {k} (a multiple of 8), N = {n}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(
            x2.data_ptr(), packed.data_ptr(), scales.data_ptr(), biases.data_ptr(), out.data_ptr(),
            m, n, k, bits, group_size, _SCALE_DTYPES[scales.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = _build.load_library().mvt_cuda_error_string(err).decode()
        raise RuntimeError(f"dequantizing matmul kernel launch failed: {msg} ({err})")
    launch_count += 1
    return out.reshape(*lead, n)
