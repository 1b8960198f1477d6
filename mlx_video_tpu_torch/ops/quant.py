"""Group-wise affine quantization (2-8 bit) in the MLX checkpoint layout.

Counterpart of mlx_video_tpu/ops/quant.py. The layout is the same:

- packed words ``(out, in * bits / 32)``, LSB-first along ``in``: for bits
  dividing 32, ``32 // bits`` values per word; for 3, 5 and 6 bits, one
  contiguous little-endian bitstream viewed as words;
- ``scales`` / ``biases`` ``(out, in / group_size)``; ``w = q * scale + bias``.

The port stores the packed words as ``torch.int32``, bit for bit the uint32
words of a checkpoint (PyTorch's uint32 has no shifts). A right shift of an
int32 sign-extends, so every shift below is followed by a mask of the bits it
keeps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

SUPPORTED_BITS = (2, 3, 4, 5, 6, 8)

# Quantization scopes of the JAX package (mlx_video_tpu/ops/quant.py), matched
# against module paths with the layer index dropped ("blocks/attn1/to_q/").
SCOPE_PATTERNS = {
    "attn1": ("blocks/attn1/",),
    "core": (
        "blocks/attn1/", "blocks/attn2/", "blocks/ff/",
        "blocks/audio_attn1/", "blocks/audio_attn2/", "blocks/audio_ff/",
        "blocks/audio_to_video_attn/", "blocks/video_to_audio_attn/",
    ),
    "all": ("blocks/",),
}


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same 32 bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _pack_bitstream(q: torch.Tensor, bits: int) -> torch.Tensor:
    """(out, in) values < 2^bits -> (out, in*bits/32) int32 words of the
    LSB-first little-endian bitstream. Each value spans at most two bytes."""
    out_dim, in_dim = q.shape
    nbytes = in_dim * bits // 8
    pos = torch.arange(in_dim, device=q.device) * bits
    b0, shift = pos // 8, pos % 8
    val = q.to(torch.int32) << shift.to(torch.int32)
    byts = torch.zeros(out_dim, nbytes + 1, dtype=torch.int32, device=q.device)
    byts.index_add_(1, b0, val & 0xFF)  # bit ranges are disjoint: add is or
    byts.index_add_(1, b0 + 1, val >> 8)
    return byts[:, :nbytes].to(torch.uint8).contiguous().view(torch.int32)


def _unpack_bitstream(packed: torch.Tensor, bits: int, in_dim: int) -> torch.Tensor:
    """Inverse of :func:`_pack_bitstream`: (out, words) -> (out, in) int32."""
    byts = packed.contiguous().view(torch.uint8).to(torch.int32)
    nbytes = byts.shape[1]
    pos = torch.arange(in_dim, device=packed.device) * bits
    b0, shift = pos // 8, pos % 8
    lo = byts[:, b0]
    hi = byts[:, torch.clamp(b0 + 1, max=nbytes - 1)]
    return ((lo | (hi << 8)) >> shift) & ((1 << bits) - 1)


def quantize_affine(
    w: torch.Tensor, group_size: int = 64, bits: int = 4
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize a 2D (out, in) matrix on its device.

    Returns (packed int32 (out, in*bits//32), scales (out, in//g) fp32,
    biases (out, in//g) fp32) with w ~= q * scales + biases per group.
    """
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
    out_dim, in_dim = w.shape
    if in_dim % group_size != 0:
        raise ValueError(f"in dim {in_dim} not divisible by group_size {group_size}")
    if (in_dim * bits) % 32 != 0:
        raise ValueError(f"in dim {in_dim} x {bits} bits does not fill whole uint32 words")
    n_groups = in_dim // group_size
    levels = (1 << bits) - 1

    wf = w.float().reshape(out_dim, n_groups, group_size)
    w_min = wf.amin(dim=-1)
    w_max = wf.amax(dim=-1)
    scales = torch.clamp((w_max - w_min) / levels, min=1e-8)
    biases = w_min
    q = torch.clamp(torch.round((wf - biases[..., None]) / scales[..., None]), 0, levels)
    q = q.to(torch.int64).reshape(out_dim, in_dim)

    if 32 % bits == 0:
        els = 32 // bits
        shifts = torch.arange(els, device=w.device) * bits
        packed = _to_int32((q.reshape(out_dim, in_dim // els, els) << shifts).sum(dim=-1))
    else:
        packed = _pack_bitstream(q, bits)
    return packed, scales, biases


def dequantize_affine(
    packed: torch.Tensor,
    scales: torch.Tensor,
    biases: torch.Tensor,
    bits: Optional[int] = None,
    dtype=torch.bfloat16,
    in_dim: Optional[int] = None,
) -> torch.Tensor:
    """Inverse of :func:`quantize_affine`: (out, in) in ``dtype``, the affine
    computed in fp32 (``q * scale`` then ``+ bias``) and rounded once.

    ``bits`` is derived from ``in_dim`` when not given (shape-only inference
    is ambiguous, so one of the two is required).
    """
    out_dim = packed.shape[0]
    n_groups = scales.shape[1]
    if bits is None:
        if in_dim is None:
            raise ValueError("dequantize_affine requires bits or in_dim")
        bits = packed.shape[1] * 32 // in_dim
        if bits not in SUPPORTED_BITS or packed.shape[1] * 32 != bits * in_dim:
            raise ValueError(f"Inconsistent quantized shapes: words={packed.shape[1]} in_dim={in_dim}")
    if 32 % bits == 0:
        els = 32 // bits
        shifts = (torch.arange(els, dtype=torch.int32, device=packed.device) * bits)[None, None, :]
        q = (packed[..., None] >> shifts) & ((1 << bits) - 1)
        in_dim = packed.shape[1] * els
        q = q.reshape(out_dim, in_dim).float()
    else:
        in_dim = packed.shape[1] * 32 // bits
        q = _unpack_bitstream(packed, bits, in_dim).float()
    group_size = in_dim // n_groups
    qg = q.reshape(out_dim, n_groups, group_size)
    w = qg * scales.float()[..., None] + biases.float()[..., None]
    return w.reshape(out_dim, in_dim).to(dtype)


def quantize_linear(layer: nn.Module, group_size: int = 64, bits: int = 4) -> nn.Module:
    """A dense ``Linear`` -> a ``QuantLinear`` on the same device, sharing
    the bias tensor (the counterpart of ``quantize_linear_params``)."""
    from mlx_video_tpu_torch.ops.linear import QuantLinear

    out_dim, in_dim = layer.weight.shape
    packed, scales, biases = quantize_affine(layer.weight, group_size, bits)
    q = QuantLinear(in_dim, out_dim, bits, group_size, bias=layer.bias is not None, device="meta")
    q.quant_weight, q.scales, q.biases = packed, scales, biases
    q.bias = layer.bias
    return q


def dequantize_linear_params(layer: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """A ``QuantLinear`` -> the dense ``Linear`` it dequantizes to (weight in
    ``dtype``), sharing the bias tensor."""
    from mlx_video_tpu_torch.ops.linear import Linear

    dense = Linear(layer.in_features, layer.out_features, bias=layer.bias is not None, device="meta")
    weight = dequantize_affine(layer.quant_weight, layer.scales, layer.biases, bits=layer.bits, dtype=dtype)
    dense.weight = nn.Parameter(weight, requires_grad=False)
    dense.bias = layer.bias
    return dense


def infer_quant_spec(name: str, in_dim: int, out_dim: int, packed_shape, scales_shape) -> Tuple[int, int]:
    """(bits, group_size) of a quantized linear from its dense (in, out) and
    the shapes of its packed words and scales; raises when they disagree or
    give an unsupported width. ``in`` disambiguates the shapes."""
    words, groups = packed_shape[-1], scales_shape[-1]
    bits = words * 32 // in_dim
    if (
        packed_shape[-2] != out_dim
        or scales_shape[-2] != out_dim
        or words * 32 != bits * in_dim
        or bits not in SUPPORTED_BITS
        or in_dim % groups != 0
    ):
        raise ValueError(
            f"Inconsistent quantized shapes for {name}: packed {tuple(packed_shape)}, scales "
            f"{tuple(scales_shape)} vs dense (in={in_dim}, out={out_dim}) — bits would be {bits}"
        )
    return bits, in_dim // groups


def use_quant_linears(module: nn.Module, specs: dict) -> nn.Module:
    """Replace the named dense ``Linear``s of ``module`` by uninitialised
    ``QuantLinear``s of ``specs[name] = (bits, group_size, scale_dtype)`` on
    the same device (``meta`` for a skeleton), in place; returns ``module``.
    Loaders call it before they fill a checkpoint's packed weights."""
    from mlx_video_tpu_torch.ops.linear import QuantLinear

    for name, (bits, group_size, scale_dtype) in specs.items():
        parent_name, _, child = name.rpartition(".")
        parent = module.get_submodule(parent_name)
        dense = getattr(parent, child)
        out_dim, in_dim = dense.weight.shape
        setattr(parent, child, QuantLinear(
            in_dim, out_dim, bits, group_size, bias=dense.bias is not None, scale_dtype=scale_dtype,
            device=dense.weight.device, dtype=dense.weight.dtype,
        ))
    return module


def jax_path(module_name: str) -> str:
    """Module path -> the JAX pytree path it sits at, layer indices dropped:
    ``blocks.3.attn1.to_q`` -> ``blocks/attn1/to_q``."""
    return "/".join(p for p in module_name.split(".") if not p.isdigit())


def quantizable(path: str, in_features: int, group_size: int, scope: str) -> bool:
    """The JAX ``quantize_dit_params`` predicate for a linear at ``path``
    (a :func:`jax_path`): inside the scope's blocks, not a q/k norm, and
    ``in`` a multiple of the group size."""
    return (
        any(p in path + "/" for p in SCOPE_PATTERNS[scope])
        and path.rsplit("/", 1)[-1] not in ("q_norm", "k_norm")
        and in_features % group_size == 0
    )


@torch.no_grad()
def quantize_dit_params(
    model: nn.Module, group_size: int = 64, bits: int = 4, scope: str = "core"
) -> nn.Module:
    """Quantize the DiT's eligible linears IN PLACE and return ``model``.

    Works one layer at a time: each eligible ``Linear`` is quantized on its
    device and replaced by a ``QuantLinear``, and its dense weight is freed
    before the next one, so the dense model is never held twice. Eligible is
    the JAX predicate (:func:`quantizable`): 2-D linear weights inside the
    scope's transformer blocks; norms, tables and adaLN MLPs stay dense.
    """
    from mlx_video_tpu_torch.ops.linear import Linear

    if scope not in SCOPE_PATTERNS:
        raise ValueError(f"scope must be one of {tuple(SCOPE_PATTERNS)}, got {scope!r}")
    names = [
        name for name, m in model.named_modules()
        if isinstance(m, Linear) and quantizable(jax_path(name), m.weight.shape[1], group_size, scope)
    ]
    for name in names:
        parent_name, _, child = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        setattr(parent, child, quantize_linear(getattr(parent, child), group_size, bits))
    return model
