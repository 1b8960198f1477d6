"""The collective layer under the rank-local code: all-reduce (sum, max),
all-gather, ring shift and broadcast on one mesh axis's group.

The sharded forward (models/ltx/model.py), the ring (ring_attention.py) and
GPipe (pipeline.py) call these and nothing else of ``torch.distributed``.
A rank sees its mesh as a :class:`MeshGroups`: each axis's size, this rank's
index along it and the axis's :class:`Group`. Three forms of a group:

- :class:`DistGroup`, the production form: ``torch.distributed`` on a
  ``DeviceMesh`` dimension's process group (NCCL on the card, gloo on the
  CPU). A failed collective raises; nothing falls back. A server whose
  ranks run one unit of work together (cli/serve.py) gives up a unit that
  failed on another rank with :func:`cancel` and :func:`renew`, so no rank
  stays waiting for a peer that has left the unit.
- :class:`SoloGroup`, an axis of size 1: every collective is the identity.
- :class:`VirtualGroup`: several virtual ranks in one process, one thread
  each (:func:`virtual_meshes`, :func:`run_virtual`), exchanging tensors by
  reference. The threads take turns: a thread runs only while it holds the
  world's lock and gives it up only inside a collective, so the virtual ranks
  interleave at the collectives, in a fixed order, as one program would run
  them. A card with one GPU runs several ranks' work this way.

Every result is a new tensor; the inputs are not modified. Sums run in rank
order within a group.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_POLL_S = 0.05  # how often a blocking (gloo) wait looks for a cancel
_cancelled = threading.Event()


class Cancelled(RuntimeError):
    """A collective given up: the unit of work it belongs to failed on
    another rank (:func:`cancel`)."""


def cancel(meshes: Sequence["MeshGroups"]) -> None:
    """Give up this rank's collectives on ``meshes`` (from another thread,
    while a unit of work runs): their process groups are aborted, so NCCL
    kernels waiting for a peer end; a gloo wait raises :class:`Cancelled`
    within ``_POLL_S``; and every later collective raises it until
    :func:`renew`."""
    _cancelled.set()
    for mesh in meshes:
        for g in mesh.groups.values():
            if isinstance(g, DistGroup):
                g.pg.abort()


def renew(meshes: Sequence["MeshGroups"]) -> None:
    """New process groups over the same ranks for every axis of ``meshes``,
    in place of the ones a cancelled unit left in an unknown state, and the
    cancel cleared. Every rank of the world calls it at the same point: each
    mesh covers the world row-major, and every rank creates every axis's
    subgroups in the same order, as ``init_device_mesh`` did."""
    rank = dist.get_rank()
    for mesh in meshes:
        shape = [mesh.size(a) for a in mesh.axes]
        layout = np.arange(int(np.prod(shape))).reshape(shape)
        for i, axis in enumerate(mesh.axes):
            if shape[i] == 1:
                continue
            for ranks in np.moveaxis(layout, i, -1).reshape(-1, shape[i]).tolist():
                pg = dist.new_group(ranks)
                if rank in ranks:
                    g = mesh.groups[axis]
                    if g.ranks != ranks:
                        raise RuntimeError(f"axis {axis}: group ranks {g.ranks} are not the mesh's {ranks}")
                    g.pg = pg
    _cancelled.clear()


class SoloGroup:
    """An axis of size 1."""

    size, rank = 1, 0

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return x

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return x

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        return x


class DistGroup:
    """One mesh axis's process group, seen from this rank; ``rank`` is the
    index along the axis."""

    def __init__(self, pg) -> None:
        self.pg = pg
        self.ranks = dist.get_process_group_ranks(pg)  # global ranks, in axis order
        self.size = len(self.ranks)
        self.rank = dist.get_rank(pg)
        self.blocking = dist.get_backend(pg) == "gloo"  # a gloo wait holds the host; NCCL's orders streams

    def _run(self, start: Callable[[], object]) -> None:
        """Start a collective (``start()`` returns its work, or a list of
        them) and wait for it. A gloo wait holds its thread until the peers
        come (a timed wait would abandon a send), so it runs in a thread of
        its own while this one looks for a :func:`cancel`."""
        if _cancelled.is_set():
            raise Cancelled("a collective of a cancelled unit of work")
        works = start()
        works = works if isinstance(works, list) else [works]
        if not self.blocking:
            for work in works:
                work.wait()
            return
        done, failed = threading.Event(), []

        def wait_all() -> None:
            try:
                for work in works:
                    work.wait()
            except BaseException as e:  # noqa: BLE001 — raised in the caller's thread
                failed.append(e)
            finally:
                done.set()

        threading.Thread(target=wait_all, daemon=True).start()
        while not done.wait(_POLL_S):
            if _cancelled.is_set():
                raise Cancelled("another rank failed this collective's unit of work")
        if failed:
            raise failed[0]

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        y = x.clone(memory_format=torch.contiguous_format)
        reduce_op = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        self._run(lambda: dist.all_reduce(y, op=reduce_op, group=self.pg, async_op=True))
        return y

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._run(lambda: dist.all_gather(parts, x, group=self.pg, async_op=True))
        return torch.cat(parts, dim=dim)

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """Send ``x`` to the next rank on the axis, return the previous one's."""
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, self.ranks[(self.rank + 1) % self.size], group=self.pg),
               dist.P2POp(dist.irecv, out, self.ranks[(self.rank - 1) % self.size], group=self.pg)]
        self._run(lambda: dist.batch_isend_irecv(ops))
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``x`` of the rank at index ``src`` on the axis; the others pass a
        tensor of the same shape and dtype."""
        y = x.clone(memory_format=torch.contiguous_format)
        self._run(lambda: dist.broadcast(y, src=self.ranks[src], group=self.pg, async_op=True))
        return y


class _VirtualWorld:
    """The threads of one in-process run: the turn lock and every group's
    exchange state, so one failure releases all waiting threads."""

    def __init__(self, timeout: float) -> None:
        self.lock = threading.Lock()
        self.timeout = timeout
        self.barriers: List[threading.Barrier] = []

    def abort(self) -> None:
        for b in self.barriers:
            b.abort()


class _VirtualComm:
    def __init__(self, world: _VirtualWorld, n: int) -> None:
        self.world = world
        self.slots: List[Optional[torch.Tensor]] = [None] * n
        self.barrier = threading.Barrier(n, timeout=world.timeout)
        world.barriers.append(self.barrier)


class VirtualGroup:
    """One axis of a virtual mesh, seen from one virtual rank."""

    def __init__(self, comm: _VirtualComm, rank: int) -> None:
        self._comm = comm
        self.size = len(comm.slots)
        self.rank = rank

    def _exchange(self, x: torch.Tensor) -> List[torch.Tensor]:
        comm = self._comm
        comm.slots[self.rank] = x
        comm.world.lock.release()  # the other ranks run up to this collective
        try:
            comm.barrier.wait()
            vals = list(comm.slots)
            comm.barrier.wait()  # nobody writes its slot again before all have read
        finally:
            comm.world.lock.acquire()
        return vals

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        vals = self._exchange(x)
        out = vals[0].clone()
        for v in vals[1:]:
            out = out + v if op == "sum" else torch.maximum(out, v)
        return out

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return torch.cat(self._exchange(x), dim=dim)

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        return self._exchange(x)[(self.rank - 1) % self.size].clone()

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        return self._exchange(x)[src].clone()


class MeshGroups:
    """A rank's view of a mesh: axis sizes, its index along each axis and the
    axis's group. An axis the mesh does not have has size 1."""

    def __init__(self, axes: Sequence[str], shape: Sequence[int], coord: Sequence[int], groups: Dict[str, object],
                 device_type: str) -> None:
        self.axes = tuple(axes)
        self.shape = dict(zip(self.axes, (int(s) for s in shape)))
        self.coord = dict(zip(self.axes, (int(c) for c in coord)))
        self.groups = dict(groups)
        self.device_type = device_type

    @classmethod
    def solo(cls, axes: Sequence[str], device_type: str) -> "MeshGroups":
        return cls(axes, [1] * len(axes), [0] * len(axes), {a: SoloGroup() for a in axes}, device_type)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coord.get(axis, 0)

    def group(self, axis: str):
        g = self.groups.get(axis)
        return SoloGroup() if g is None or self.size(axis) == 1 else g

    def __repr__(self) -> str:
        return f"MeshGroups({self.shape}, at {self.coord})"


def mesh_groups(mesh) -> MeshGroups:
    """The :class:`MeshGroups` of a ``DeviceMesh`` (its dimensions' process
    groups) or of a :class:`MeshGroups` (itself)."""
    if isinstance(mesh, MeshGroups):
        return mesh
    cached = getattr(mesh, "_mvt_groups", None)
    if cached is not None:
        return cached
    axes = mesh.mesh_dim_names
    shape = tuple(mesh.shape)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    groups = {}
    for axis, size, c in zip(axes, shape, coord):
        if size > 1:
            groups[axis] = DistGroup(mesh.get_group(axis))
            if groups[axis].rank != c:
                raise RuntimeError(f"axis {axis}: group rank {groups[axis].rank} is not mesh coordinate {c}")
    out = MeshGroups(axes, shape, coord, groups, mesh.device_type)
    mesh._mvt_groups = out
    return out


def virtual_meshes(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda",
                   timeout: float = 120.0) -> List[MeshGroups]:
    """One :class:`MeshGroups` per virtual rank of a row-major mesh of
    ``shape``, with :class:`VirtualGroup` axes; run them with
    :func:`run_virtual`."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    world = _VirtualWorld(timeout)
    grid = np.arange(n).reshape(shape)
    groups: List[Dict[str, object]] = [dict() for _ in range(n)]
    for d, axis in enumerate(axes):
        if shape[d] == 1:
            continue
        lines = np.moveaxis(grid, d, -1).reshape(-1, shape[d])
        for line in lines:
            comm = _VirtualComm(world, shape[d])
            for i, r in enumerate(line):
                groups[int(r)][axis] = VirtualGroup(comm, i)
    meshes = [MeshGroups(axes, shape, np.unravel_index(r, shape), groups[r], device_type) for r in range(n)]
    for m in meshes:
        m._virtual_world = world
    return meshes


def run_virtual(meshes: Sequence[MeshGroups], fn: Callable[[MeshGroups], object], timeout: float = 600.0) -> list:
    """``fn(mesh)`` for every virtual rank, each in its own thread, taking
    turns at the collectives; returns the results in rank order. The first
    exception of any rank is raised (the others are released)."""
    world: _VirtualWorld = meshes[0]._virtual_world
    results: List[object] = [None] * len(meshes)
    errors: List[Tuple[int, BaseException]] = []

    def body(r: int) -> None:
        with world.lock:
            try:
                results[r] = fn(meshes[r])
            except BaseException as e:  # noqa: BLE001 (re-raised by the caller)
                errors.append((r, e))
                world.abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True) for r in range(len(meshes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        world.abort()
        raise TimeoutError(f"virtual ranks did not finish in {timeout} s")
    if errors:
        errors.sort(key=lambda e: isinstance(e[1], threading.BrokenBarrierError))
        raise errors[0][1]
    return results
