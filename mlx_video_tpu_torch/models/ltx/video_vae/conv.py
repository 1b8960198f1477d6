"""Causal 3D convolution for the video VAE, on NCDHW tensors.

Counterpart of mlx_video_tpu/models/ltx/video_vae/conv.py:causal_conv3d.
Weights use PyTorch's (O, I, kd, kh, kw) layout; the JAX package stores
(kd, kh, kw, I, O) and io/jax_bridge.py permutes between the two. The
convolution itself is ``F.conv3d`` (cuDNN on the card).

Row split (``rows``, a group of parallel/collectives.py over which H is cut
in equal slices, this rank's the ``rows.rank``-th): the conv is rank-local.
In place of its spatial padding of H, a slice takes ``kh // 2`` halo rows
from each neighbour (``rows.halo_exchange``); the zero or reflect padding
stays at the global edges only, where reflect reads the neighbour's halo
when a rank holds fewer rows than it mirrors. The output rows are this
rank's rows of the whole conv's output.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from mlx_video_tpu_torch.ops.linear import uniform_

PaddingMode = str  # "zeros" | "reflect"


def _triple(v) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)


class Conv3d(nn.Module):
    """Parameter holder: weight (O, I, kd, kh, kw), bias (O,)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, device=None, dtype=None):
        super().__init__()
        kd, kh, kw = _triple(kernel_size)
        kw_ = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kd, kh, kw, **kw_), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(out_channels, **kw_), requires_grad=False)


class Conv2d(nn.Module):
    """Parameter holder: weight (O, I, kh, kw), bias (O,)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, device=None, dtype=None):
        super().__init__()
        kw_ = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size, **kw_), requires_grad=False
        )
        self.bias = nn.Parameter(torch.empty(out_channels, **kw_), requires_grad=False)


def init_conv_(conv: nn.Module, generator: torch.Generator) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and zero bias."""
    fan_in = conv.weight[0].numel()
    uniform_(conv.weight, fan_in**-0.5, generator)
    conv.bias.zero_()


def temporal_causal_pad(x: torch.Tensor, time_kernel: int, causal: bool) -> torch.Tensor:
    """Edge-replicate temporal padding of (B, C, F, H, W): causal repeats the
    first frame k-1 times in front; non-causal repeats first and last frames
    (k-1)//2 times on each side."""
    if time_kernel <= 1:
        return x
    if causal:
        return torch.cat([x[:, :, :1].expand(-1, -1, time_kernel - 1, -1, -1), x], dim=2)
    pad = (time_kernel - 1) // 2
    if pad == 0:
        return x
    first = x[:, :, :1].expand(-1, -1, pad, -1, -1)
    last = x[:, :, -1:].expand(-1, -1, pad, -1, -1)
    return torch.cat([first, x, last], dim=2)


def spatial_pad(x: torch.Tensor, pad_h: int, pad_w: int, mode: PaddingMode, rows=None) -> torch.Tensor:
    """Zero or reflect (boundary-excluding) padding of H and W of (B, C, F,
    H, W); under a row split (``rows``) H takes the neighbours' halo rows
    inside and the padding at the global edges only."""
    if pad_h == 0 and pad_w == 0:
        return x
    if rows is not None and rows.size > 1:
        x = _halo_rows(x, pad_h, mode, rows)
        pad_h = 0
    if mode == "reflect":
        return F.pad(x, (pad_w, pad_w, pad_h, pad_h, 0, 0), mode="reflect")
    return F.pad(x, (pad_w, pad_w, pad_h, pad_h))


def _halo_rows(x: torch.Tensor, pad: int, mode: PaddingMode, rows) -> torch.Tensor:
    """This rank's slice of H with ``pad`` rows above and below: the
    neighbours' rows inside, the global edge's zero or reflect rows at the
    first and last rank."""
    up, down = rows.halo_exchange(x, pad, pad, dim=3)

    def edge(ext: torch.Tensor, top: bool) -> torch.Tensor:
        if mode != "reflect":
            return torch.zeros_like(ext.narrow(3, 0, pad))
        if ext.shape[3] < pad + 1:
            raise ValueError(f"reflect padding of {pad} rows needs {pad + 1} rows at the edge, the edge rank and "
                             f"its neighbour hold {ext.shape[3]}")
        return (ext.narrow(3, 1, pad) if top else ext.narrow(3, ext.shape[3] - pad - 1, pad)).flip(3)

    top = up if up is not None else edge(torch.cat([x, down], dim=3), True)
    bottom = down if down is not None else edge(torch.cat([up, x], dim=3), False)
    return torch.cat([top, x, bottom], dim=3)


def causal_conv3d(
    conv: Conv3d,
    x: torch.Tensor,
    kernel_size: Union[int, Tuple[int, int, int]],
    stride: Union[int, Tuple[int, int, int]] = 1,
    causal: bool = False,
    padding_mode: PaddingMode = "zeros",
    rows=None,
) -> torch.Tensor:
    """3D convolution over (B, C, F, H, W) with edge-replicate temporal
    padding and k//2 zero/reflect spatial padding; the bias is added in fp32
    and the sum cast back to x's dtype. ``rows``: the row split of the
    module docstring (stride 1 along H)."""
    kd, kh, kw = _triple(kernel_size)
    if rows is not None and rows.size > 1 and _triple(stride)[1] != 1:
        raise ValueError("a row-split conv takes stride 1 along H")
    x = spatial_pad(temporal_causal_pad(x, kd, causal), kh // 2, kw // 2, padding_mode, rows)
    out = F.conv3d(x, conv.weight.to(x.dtype), stride=_triple(stride))
    return (out.float() + conv.bias.float().reshape(1, -1, 1, 1, 1)).to(x.dtype)
