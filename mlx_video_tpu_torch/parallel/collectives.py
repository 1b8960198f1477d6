"""The collective layer under the rank-local code: all-reduce (sum, max),
all-gather, reduce-scatter, ring shift, broadcast and the halo exchange of a
row split on one mesh axis's group (or on several axes flattened,
:meth:`MeshGroups.flat`).

The sharded forward and backward (models/ltx/model.py, ops/linear.py,
ops/norms.py), the ring (ring_attention.py), GPipe (pipeline.py), the
trainer's gradient sums (trainer/train_step.py) and the row-split upsample
and decode (models/ltx/video_vae/, models/ltx/upsampler.py) call these and
nothing else of ``torch.distributed``. A rank sees its mesh as a
:class:`MeshGroups`: each axis's size, this rank's index along it and the
axis's :class:`Group`. Three forms of a group:

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
order within a group (NCCL's own order on the card).

The collectives that carry a gradient (``torch.autograd.Function``s on any
group form), Megatron's pair for tensor parallelism and FSDP's gather:

- :func:`reduce_from`: the row-parallel sum, all-reduce forward, identity
  backward (what follows it runs alike on every rank of the group, so each
  rank's gradient of the sum is already whole);
- :func:`copy_to`: its column-parallel partner, identity forward, all-reduce
  backward (each rank's branch sees only its share of the gradient);
- :func:`gather_sum`: all-gather forward, reduce-scatter backward (FSDP's
  weight gather and the sequence split: every rank's use of the whole
  tensor adds to its owner's gradient);
- :func:`gather_split`: all-gather forward, this rank's slice of the
  gradient backward (a tensor-parallel weight gathered whole for work every
  rank of the group repeats alike).
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
        for g in list(mesh.groups.values()) + list(mesh._flat.values()):
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
        mesh._flat.clear()  # flattened groups are made again, by every rank alike, at their next use
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

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return x

    def halo_exchange(self, x: torch.Tensor, rows_up: int, rows_down: int, dim: int):
        return None, None


def _halo_check(x: torch.Tensor, rows_up: int, rows_down: int, dim: int) -> None:
    """A rank gives its neighbours rows of its own slice only."""
    if max(rows_up, rows_down) > x.shape[dim]:
        raise ValueError(f"a halo of {max(rows_up, rows_down)} rows needs slices of at least that many rows, "
                         f"this rank holds {x.shape[dim]}")


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

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's part (of ``size`` equal ones along ``dim``) of the sum
        of every rank's ``x``: NCCL's reduce-scatter; on gloo, which has
        none, the all-reduce and this rank's part of it."""
        if dist.get_backend(self.pg) != "nccl":
            return self.all_reduce(x).chunk(self.size, dim=dim)[self.rank].contiguous()
        parts = x.movedim(dim, 0).contiguous()
        out = torch.empty((parts.shape[0] // self.size,) + tuple(parts.shape[1:]), dtype=x.dtype, device=x.device)
        self._run(lambda: dist.reduce_scatter_tensor(out, parts, group=self.pg, async_op=True))
        return out.movedim(0, dim)

    def halo_exchange(self, x: torch.Tensor, rows_up: int, rows_down: int, dim: int):
        """The last ``rows_up`` rows (along ``dim``) of the previous rank's
        ``x`` and the first ``rows_down`` of the next one's, by p2p; None
        beyond the first and the last rank (no cycle)."""
        _halo_check(x, rows_up, rows_down, dim)
        up = down = None
        ops = []
        n = x.shape[dim]
        if self.rank > 0:
            prev = self.ranks[self.rank - 1]
            if rows_down:  # the previous rank's down halo: my first rows
                ops.append(dist.P2POp(dist.isend, x.narrow(dim, 0, rows_down).contiguous(), prev, group=self.pg))
            if rows_up:
                up = torch.empty_like(x.narrow(dim, 0, rows_up), memory_format=torch.contiguous_format)
                ops.append(dist.P2POp(dist.irecv, up, prev, group=self.pg))
        if self.rank < self.size - 1:
            nxt = self.ranks[self.rank + 1]
            if rows_up:  # the next rank's up halo: my last rows
                ops.append(dist.P2POp(dist.isend, x.narrow(dim, n - rows_up, rows_up).contiguous(), nxt,
                                      group=self.pg))
            if rows_down:
                down = torch.empty_like(x.narrow(dim, 0, rows_down), memory_format=torch.contiguous_format)
                ops.append(dist.P2POp(dist.irecv, down, nxt, group=self.pg))
        if ops:
            self._run(lambda: dist.batch_isend_irecv(ops))
        return up, down


class _VirtualWorld:
    """The threads of one in-process run: the turn lock and every group's
    exchange state, so one failure releases all waiting threads."""

    def __init__(self, timeout: float) -> None:
        self.lock = threading.Lock()
        self.timeout = timeout
        self.barriers: List[threading.Barrier] = []
        self.flat: Dict[tuple, "_VirtualComm"] = {}  # flattened axes' comms, made by the first rank to ask

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

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        vals = [v.chunk(self.size, dim=dim)[self.rank] for v in self._exchange(x)]
        out = vals[0].clone(memory_format=torch.contiguous_format)
        for v in vals[1:]:
            out = out + v
        return out

    def halo_exchange(self, x: torch.Tensor, rows_up: int, rows_down: int, dim: int):
        _halo_check(x, rows_up, rows_down, dim)
        vals = self._exchange(x)
        up = down = None
        if self.rank > 0 and rows_up:
            prev = vals[self.rank - 1]
            up = prev.narrow(dim, prev.shape[dim] - rows_up, rows_up).clone()
        if self.rank < self.size - 1 and rows_down:
            down = vals[self.rank + 1].narrow(dim, 0, rows_down).clone()
        return up, down


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
        self._flat: Dict[Tuple[str, ...], object] = {}

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

    def flat(self, axes: Sequence[str]):
        """The group over ``axes`` flattened row-major (the first the
        slowest), as JAX cuts a dimension over a tuple of mesh axes: this
        rank's index is the row-major index of its coordinates on them.
        Axes of size 1 drop out; one axis left is its own group. A
        :class:`DistGroup` over several is made at the first call, by every
        rank of the world at the same point (all lines' groups, in order)."""
        axes = tuple(a for a in axes if self.size(a) > 1)
        if not axes:
            return SoloGroup()
        if len(axes) == 1:
            return self.group(axes[0])
        if axes not in self._flat:
            self._flat[axes] = self._make_flat(axes)
        return self._flat[axes]

    def _make_flat(self, axes: Tuple[str, ...]):
        shape = [self.size(a) for a in self.axes]
        at = [self.axes.index(a) for a in axes]
        rest = [d for d in range(len(self.axes)) if d not in at]
        grid = np.arange(int(np.prod(shape))).reshape(shape).transpose(rest + at).reshape(-1, int(np.prod(
            [shape[d] for d in at])))
        me = int(np.ravel_multi_index([self.index(a) for a in self.axes], shape))
        line = int(np.nonzero((grid == me).any(axis=1))[0][0])
        index = int(np.nonzero(grid[line] == me)[0][0])
        world = getattr(self, "_virtual_world", None)
        if world is not None:
            key = (axes, line)
            if key not in world.flat:
                world.flat[key] = _VirtualComm(world, grid.shape[1])
            return VirtualGroup(world.flat[key], index)
        mine = None
        for ranks in grid.tolist():  # the world's ranks lie row-major over the mesh, as create_mesh lays them
            pg = dist.new_group(ranks)
            if me in ranks:
                mine = DistGroup(pg)
        if mine.rank != index:
            raise RuntimeError(f"flattened {axes}: group rank {mine.rank} is not the mesh's {index}")
        return mine

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
    exception of any rank is raised (the others are released). A rank's
    backward runs in its own thread (autograd's device threads are off
    there): the collectives of one rank's backward would otherwise hold the
    device thread the other ranks' backwards wait for."""
    world: _VirtualWorld = meshes[0]._virtual_world
    results: List[object] = [None] * len(meshes)
    errors: List[Tuple[int, BaseException]] = []

    def body(r: int) -> None:
        with world.lock, torch.autograd.set_multithreading_enabled(False):
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


# ---------------------------------------------------------------------------
# Collectives that carry a gradient
# ---------------------------------------------------------------------------


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, dy):
        return ctx.group.all_reduce(dy), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim: int, reduce: bool):
        ctx.group, ctx.dim, ctx.reduce = group, dim, reduce
        return group.all_gather(x, dim=dim)

    @staticmethod
    def backward(ctx, dy):
        g = ctx.group
        dx = g.reduce_scatter(dy, dim=ctx.dim) if ctx.reduce else dy.chunk(g.size, dim=ctx.dim)[g.rank]
        return dx.contiguous(), None, None, None


def _differentiable(x: torch.Tensor, group) -> bool:
    return torch.is_grad_enabled() and x.requires_grad and group.size > 1


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The row-parallel sum over ``group``: all-reduce forward, identity
    backward."""
    return _ReduceFrom.apply(x, group) if _differentiable(x, group) else group.all_reduce(x)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """The column-parallel entry: ``x`` itself forward, its gradient
    all-reduced over ``group`` backward."""
    return _CopyTo.apply(x, group) if _differentiable(x, group) else x


def gather_sum(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather along ``dim`` forward, reduce-scatter of the gradient
    backward."""
    return _Gather.apply(x, group, dim, True) if _differentiable(x, group) else group.all_gather(x, dim=dim)


def gather_split(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather along ``dim`` forward, this rank's slice of the gradient
    backward."""
    return _Gather.apply(x, group, dim, False) if _differentiable(x, group) else group.all_gather(x, dim=dim)
