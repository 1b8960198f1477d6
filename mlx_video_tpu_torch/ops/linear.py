"""Linear layers: dense, group-affine quantized and int8, with optional LoRA
adapters.

Counterpart of mlx_video_tpu/ops/linear.py:linear. Dense weights use PyTorch's
``(out_features, in_features)`` layout; the JAX package stores ``(in, out)``,
and io/jax_bridge.py transposes between the two. Quantized weights keep the
MLX ``(out, ...)`` layout in both packages (ops/quant.py).

Routes of :func:`linear` for a :class:`QuantLinear`, decided from ``bits``
alone:
- 2, 4 or 8 bits: the dequantizing matmul K2 (ops/quant_matmul.py), which
  launches its CUDA kernel on a CUDA tensor (or raises on operands it cannot
  take) and computes its plain version on a CPU tensor;
- 3, 5 or 6 bits: plain :func:`dequantize_affine` then ``torch.matmul``, as
  the JAX package computes them outside any Pallas kernel.

A quantized product is differentiable in x only (the frozen base has no
weight gradient): its backward is dy @ dequant(W), plain
:func:`dequantize_affine` then ``torch.matmul``, as XLA differentiates the JAX
quantized branch.

LoRA (lora.py adds the leaves): a layer with ``lora_A`` (r, in), ``lora_B``
(out, r) and ``lora_scale`` adds ``lora_scale * (x A^T) B^T``, computed in fp32
and cast to y's dtype, as ``_apply_lora``. Its products are plain autograd
ops in full fp32, PyTorch's default (the JAX package's ``Precision.HIGHEST``);
the trainer refuses to start with TF32 switched on.

The int8 branches (ops/int8.py), as JAX computes them outside any Pallas
kernel:
- W8A8, an :class:`Int8Linear` (``int8_weight`` (out, in) int8,
  ``int8_scale`` (out,) fp32): per-token activation codes, an int32 product,
  an fp32 rescale and bias, cast to x's dtype;
- W4A8, a :class:`QuantLinear` that carries ``int8_scale`` (ops/quant.py:
  prepare_w4a8): its words are dequantized to fp32, requantized per output
  channel to int8 and multiplied the same way. K2 is not used; the int8
  weight is a transient of this one layer, as in JAX.
Both are differentiable in x by the straight-through estimator; LoRA adds
its delta on top, as on every other branch.

Tensor parallelism (parallel/sharding.py), Megatron's: a column-parallel
layer (``tp_copy`` set) holds its rank's rows of the weight and takes x
through collectives.copy_to (the identity; in the backward its gradient of
x is summed over the group). A row-parallel one (``tp_group`` set: it
holds its rank's slice of the in dimension and takes that slice of x)
computes its partial product without the bias, sums it over the group in
fp32 through collectives.reduce_from (the int8 branches: the int32
products, after codes made from the group's absmax) and adds the whole bias
once, after the sum. K2 runs on the rank's words, forward and (dx =
dy dequant(W)) backward. LoRA factors follow their linear's cut: a
column-parallel layer keeps A whole and B's rows, so its x A^T enters B
through copy_to; a row-parallel one keeps A's columns and B whole, so its
partial x A^T is summed (reduce_from) before B. Every rank of the group
then holds whole gradients of what it holds whole.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from mlx_video_tpu_torch.ops.int8 import int8_act_matmul, int8_linear
from mlx_video_tpu_torch.ops.quant import SUPPORTED_BITS, dequantize_affine
from mlx_video_tpu_torch.ops.quant_matmul import KERNEL_BITS, quant_matmul
from mlx_video_tpu_torch.parallel.collectives import copy_to, reduce_from


class Linear(nn.Module):
    """Parameter holder for :func:`linear`; created uninitialised (see
    :func:`init_linear_`), so building a model draws no random numbers."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features, **kw), requires_grad=False)
        self.bias = (
            nn.Parameter(torch.empty(out_features, **kw), requires_grad=False) if bias else None
        )


class QuantLinear(nn.Module):
    """Group-affine quantized linear, under the JAX leaf names:
    ``quant_weight`` (out, in*bits/32) int32 words (the checkpoint's uint32
    bits), ``scales`` and ``biases`` (out, in/group_size), optional ``bias``.
    Created uninitialised, like :class:`Linear`."""

    def __init__(self, in_features: int, out_features: int, bits: int, group_size: int,
                 bias: bool = True, scale_dtype=torch.float32, device=None, dtype=None):
        super().__init__()
        if bits not in SUPPORTED_BITS:
            raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
        if in_features % group_size or (in_features * bits) % 32:
            raise ValueError(f"in_features {in_features} does not fit group {group_size} at {bits} bits")
        self.in_features, self.out_features = in_features, out_features
        self.bits, self.group_size = bits, group_size
        groups = in_features // group_size
        self.register_buffer(
            "quant_weight", torch.empty(out_features, in_features * bits // 32, dtype=torch.int32, device=device)
        )
        self.register_buffer("scales", torch.empty(out_features, groups, dtype=scale_dtype, device=device))
        self.register_buffer("biases", torch.empty(out_features, groups, dtype=scale_dtype, device=device))
        self.bias = (
            nn.Parameter(torch.empty(out_features, device=device, dtype=dtype), requires_grad=False)
            if bias else None
        )

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bits={self.bits}, group_size={self.group_size}")


class Int8Linear(nn.Module):
    """W8A8 linear under the JAX leaf names: ``int8_weight`` (out, in) int8
    codes, ``int8_scale`` (out,) fp32 per-channel scales (ops/int8.py:
    quantize_weight_int8), optional ``bias``. Created uninitialised, like
    :class:`Linear`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("int8_weight", torch.empty(out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("int8_scale", torch.empty(out_features, dtype=torch.float32, device=device))
        self.bias = (
            nn.Parameter(torch.empty(out_features, device=device, dtype=dtype), requires_grad=False)
            if bias else None
        )

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, int8"


def w4a8_linear(layer: QuantLinear, x: torch.Tensor, group=None) -> torch.Tensor:
    """The W4A8 branch: dequantize the layer's words to fp32, requantize per
    output channel by its ``int8_scale``, int8 product with per-token
    activation codes (summed over ``group`` when row-parallel), fp32 bias,
    cast to x's dtype."""
    w_scale = layer.int8_scale.float()
    wf = dequantize_affine(layer.quant_weight, layer.scales, layer.biases, bits=layer.bits, dtype=torch.float32)
    w_q8 = torch.clamp(torch.round(wf / w_scale[:, None]), -127, 127).to(torch.int8)
    del wf
    y = int8_act_matmul(x.float(), w_q8, w_scale, 1, group)
    if layer.bias is not None:
        y = y + layer.bias.float()
    return y.to(x.dtype)


class _QuantMatmul(torch.autograd.Function):
    """K2 forward; the backward gives dx = dy dequant(W) only."""

    @staticmethod
    def forward(ctx, x, packed, scales, biases, bits: int, group_size: int):
        ctx.save_for_backward(packed, scales, biases)
        ctx.bits = bits
        return quant_matmul(x, packed, scales, biases, bits, group_size)

    @staticmethod
    def backward(ctx, dy):
        packed, scales, biases = ctx.saved_tensors
        w = dequantize_affine(packed, scales, biases, bits=ctx.bits, dtype=dy.dtype)
        return torch.matmul(dy, w), None, None, None, None, None


def linear(layer: Union[Linear, QuantLinear, Int8Linear], x: torch.Tensor) -> torch.Tensor:
    """y = x W^T (+ b) in x's dtype, plus the layer's LoRA delta if it has
    one. fp32 operands stay full fp32 (PyTorch's default matmul precision);
    bf16 operands accumulate in fp32 on the card. A quantized layer adds its
    bias after the product, in x's dtype; an int8 one (W8A8, or W4A8 when a
    quantized layer carries ``int8_scale``) in fp32 before the cast. A
    row-parallel layer (``tp_group``) sums over its group first."""
    group = getattr(layer, "tp_group", None)
    if group is not None:
        return _row_parallel(layer, x, group)
    col = getattr(layer, "tp_copy", None)
    xin = x if col is None else copy_to(x, col)
    if isinstance(layer, Int8Linear):
        y = int8_linear(xin, layer.int8_weight, layer.int8_scale, layer.bias)
    elif isinstance(layer, QuantLinear) and getattr(layer, "int8_scale", None) is not None:
        y = w4a8_linear(layer, xin)
    elif not isinstance(layer, QuantLinear):
        y = F.linear(xin, layer.weight, layer.bias)
    else:
        y = _quant_product(layer, xin)
        if layer.bias is not None:
            y = y + layer.bias.to(x.dtype)
    delta = _lora_delta(layer, x, col=col)
    return y if delta is None else y + delta.to(y.dtype)


def _quant_product(layer: QuantLinear, x: torch.Tensor) -> torch.Tensor:
    """x dequant(W)^T without the bias: K2 for its widths, else plain."""
    if layer.bits in KERNEL_BITS:
        return _QuantMatmul.apply(x, layer.quant_weight, layer.scales, layer.biases, layer.bits, layer.group_size)
    w = dequantize_affine(layer.quant_weight, layer.scales, layer.biases, bits=layer.bits, dtype=x.dtype)
    return torch.matmul(x, w.T)


def _lora_delta(layer, x: torch.Tensor, col=None, row=None) -> Optional[torch.Tensor]:
    """The layer's fp32 LoRA update ``lora_scale * (x A^T) B^T``, or None;
    x A^T enters B through copy_to over ``col`` (column-parallel) or summed
    over ``row`` (row-parallel: A holds this rank's columns)."""
    if getattr(layer, "lora_A", None) is None:
        return None
    u = x.float() @ layer.lora_A.float().T
    if row is not None:
        u = reduce_from(u, row)
    elif col is not None:
        u = copy_to(u, col)
    return (u @ layer.lora_B.float().T) * layer.lora_scale


def _row_parallel(layer: Union[Linear, QuantLinear, Int8Linear], x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel layer's whole output from this rank's slice of x."""
    delta = _lora_delta(layer, x, row=group)
    if isinstance(layer, Int8Linear) or getattr(layer, "int8_scale", None) is not None:
        y = (int8_linear(x, layer.int8_weight, layer.int8_scale, layer.bias, group) if isinstance(layer, Int8Linear)
             else w4a8_linear(layer, x, group))
        return y if delta is None else y + delta.to(y.dtype)
    part = _quant_product(layer, x) if isinstance(layer, QuantLinear) else F.linear(x, layer.weight)
    y = reduce_from(part.float(), group)
    if layer.bias is not None:
        y = y + layer.bias.float()
    if delta is not None:
        y = y + delta
    return y.to(x.dtype)


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with U(-bound, bound) drawn in fp32 on t's device,
    then rounded to t's dtype (the JAX init draws fp32 and casts)."""
    draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    draw.uniform_(-bound, bound, generator=generator)
    return t.copy_(draw)


def init_linear_(layer: Linear, generator: torch.Generator, scale: Optional[float] = None) -> None:
    """U(-1/sqrt(in), 1/sqrt(in)) weights and zero bias, as ``init_linear``."""
    if scale is None:
        scale = layer.weight.shape[1] ** -0.5
    uniform_(layer.weight, scale, generator)
    if layer.bias is not None:
        layer.bias.zero_()
