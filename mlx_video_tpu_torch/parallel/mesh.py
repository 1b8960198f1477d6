"""Device meshes for multi-GPU execution: a ``(data, fsdp, tensor)``
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the world.

Counterpart of mlx_video_tpu/parallel/mesh.py. Ranks are laid out row-major
over the shape, as JAX reshapes its device list; each mesh dimension's
process group carries that axis's collectives (parallel/collectives.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from mlx_video_tpu_torch.parallel.collectives import MeshGroups
from mlx_video_tpu_torch.parallel.distributed import default_device_type, ensure_world

AXES = ("data", "fsdp", "tensor")


def factor_devices(n: int) -> Tuple[int, int, int]:
    """Factor n devices into (data, fsdp, tensor).

    Heuristic: give tensor parallelism the largest power-of-two factor up to
    8 (attention heads / FFN columns split cleanly and TP collectives are the
    most latency-sensitive, so they should ride the innermost ICI axis), then
    fsdp, then data.
    """
    tensor = 1
    while tensor * 2 <= min(n, 8) and n % (tensor * 2) == 0:
        tensor *= 2
    rest = n // tensor
    fsdp = 1
    while fsdp * 2 <= rest and rest % (fsdp * 2) == 0:
        fsdp *= 2
    data = rest // fsdp
    return (data, fsdp, tensor)


def create_mesh(shape: Optional[Tuple[int, ...]] = None, device_type: Optional[str] = None,
                axes: Tuple[str, ...] = AXES) -> DeviceMesh:
    """A ``(data, fsdp, tensor)`` mesh over the whole world (joined first:
    the launcher's group, or a world-1 group of this process alone);
    ``shape`` defaults to :func:`factor_devices` of the world size."""
    device_type = device_type or default_device_type()
    n = ensure_world(device_type)
    if shape is None:
        shape = factor_devices(n)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"Mesh shape {shape} does not cover {n} devices")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def single_device_mesh(device_type: Optional[str] = None) -> MeshGroups:
    """A (1, 1, 1) mesh over this rank's own device: every axis of size 1,
    so nothing is sharded and no collective runs (any world size)."""
    return MeshGroups.solo(AXES, device_type or default_device_type())
