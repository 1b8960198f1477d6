"""Normalisations with fp32 accumulation; output in the input dtype.

Counterpart of mlx_video_tpu/ops/norms.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from mlx_video_tpu_torch.parallel.collectives import copy_to, reduce_from


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None, eps: float = 1e-6, group=None) -> torch.Tensor:
    """RMS norm over the last dim; fp32 accumulation, output in input dtype.
    With ``group`` (parallel/collectives.py) the last dim is this rank's
    slice of a dimension split over the group (the q/k norms under tensor
    parallelism): the sum of squares is summed over the group, and its
    gradient too (every rank's slice depends on the whole sum)."""
    xf = x.float()
    if group is None:
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        ms = copy_to(reduce_from(torch.sum(xf * xf, dim=-1, keepdim=True), group), group) / (xf.shape[-1] * group.size)
    out = xf * torch.rsqrt(ms + eps)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm over the last dim (the DiT output norm)."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
