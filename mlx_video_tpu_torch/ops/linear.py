"""Dense linear layer.

Counterpart of the dense branch of mlx_video_tpu/ops/linear.py:linear.
Weights use PyTorch's ``(out_features, in_features)`` layout; the JAX package
stores ``(in, out)``, and io/jax_bridge.py transposes between the two.
Quantized weights and LoRA are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Module):
    """Parameter holder for :func:`linear`; created uninitialised (see
    :func:`init_linear_`), so building a model draws no random numbers."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(out_features, in_features, **kw), requires_grad=False)
        self.bias = (
            nn.Parameter(torch.empty(out_features, **kw), requires_grad=False) if bias else None
        )


def linear(layer: Linear, x: torch.Tensor) -> torch.Tensor:
    """y = x W^T (+ b) in x's dtype. fp32 operands stay full fp32 (PyTorch's
    default matmul precision); bf16 operands accumulate in fp32 on the card."""
    return F.linear(x, layer.weight, layer.bias)


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
