"""Tensor statistics at pipeline seams, for debugging.

Counterpart of mlx_video_tpu/utils/debug.py. On when ``LTX_DEBUG=1`` or
``MLX_VIDEO_DEBUG=1`` (the generate CLI's ``--debug`` and ``--verbose`` set
the latter); the statistics are reduced on the tensor's device and read
back as four numbers. The line is the JAX one: the population standard
deviation, and the dtype by its JAX name (``bfloat16``, not
``torch.bfloat16``).
"""

from __future__ import annotations

import os
import sys

import torch


def debug_enabled() -> bool:
    return os.environ.get("LTX_DEBUG") == "1" or os.environ.get("MLX_VIDEO_DEBUG") == "1"


def debug_stats(name: str, tensor: torch.Tensor, file=None) -> None:
    """Print shape/min/max/mean/std for a tensor when debugging is on."""
    if not debug_enabled():
        return
    t = tensor.detach().float()
    stats = torch.stack([t.min(), t.max(), t.mean(), t.std(correction=0)]).tolist()
    print(
        f"[debug] {name}: shape={tuple(tensor.shape)} dtype={str(tensor.dtype).removeprefix('torch.')} "
        f"min={stats[0]:.4f} max={stats[1]:.4f} mean={stats[2]:.4f} std={stats[3]:.4f}",
        file=file or sys.stderr,
        flush=True,
    )
