"""Linear layers: dense and group-affine quantized, with optional LoRA adapters.

Counterpart of the dense, quantized and LoRA branches of
mlx_video_tpu/ops/linear.py:linear. Dense weights use PyTorch's
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

The int8 (W8A8, W4A8) branches are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from mlx_video_tpu_torch.ops.quant import SUPPORTED_BITS, dequantize_affine
from mlx_video_tpu_torch.ops.quant_matmul import KERNEL_BITS, quant_matmul


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


def linear(layer: Union[Linear, QuantLinear], x: torch.Tensor) -> torch.Tensor:
    """y = x W^T (+ b) in x's dtype, plus the layer's LoRA delta if it has
    one. fp32 operands stay full fp32 (PyTorch's default matmul precision);
    bf16 operands accumulate in fp32 on the card. A quantized layer adds its
    bias after the product, in x's dtype."""
    if not isinstance(layer, QuantLinear):
        y = F.linear(x, layer.weight, layer.bias)
    else:
        if layer.bits in KERNEL_BITS:
            y = _QuantMatmul.apply(x, layer.quant_weight, layer.scales, layer.biases, layer.bits, layer.group_size)
        else:
            w = dequantize_affine(layer.quant_weight, layer.scales, layer.biases, bits=layer.bits, dtype=x.dtype)
            y = torch.matmul(x, w.T)
        if layer.bias is not None:
            y = y + layer.bias.to(x.dtype)
    if getattr(layer, "lora_A", None) is not None:
        delta = (x.float() @ layer.lora_A.float().T) @ layer.lora_B.float().T
        y = y + (delta * layer.lora_scale).to(y.dtype)
    return y


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
