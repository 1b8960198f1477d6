"""Multi-process start-up and preemption-aware restart on torch.distributed.

Counterpart of mlx_video_tpu/parallel/distributed.py. One program runs on
every rank; the ranks are started by ``torchrun`` (or any launcher that sets
its variables) and joined here:

1. :func:`initialize_multihost` joins the process group from the launcher's
   ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
   ``LOCAL_RANK`` (where JAX reads ``JAX_COORDINATOR_ADDRESS``,
   ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``), or from its arguments. The
   backend is NCCL for CUDA devices and gloo for CPU ones; on CUDA each rank
   takes ``cuda:LOCAL_RANK``. A single process without a launcher is world
   size 1 and joins nothing; a partial configuration raises.
2. :class:`PreemptionGuard` turns SIGTERM into a flag read at step
   boundaries, OR-reduced over the world so every rank stops at one step.
3. Restart is resume: the trainer's exact-resume checkpoints.
4. :class:`WorkChannel` hands rank 0's units of work (the server's
   requests) to the other ranks through the group's key-value store, so a
   rank waiting for work waits at no collective; every rank reports each
   unit, and a failure report cancels the other ranks' collectives.

Nothing here falls back: a failed init or collective raises.
"""

from __future__ import annotations

import datetime
import json
import os
import signal
import threading
import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_INITIALIZED = False


def default_device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def backend_for(device_type: str) -> str:
    """NCCL for CUDA devices, gloo for CPU ones."""
    return "nccl" if device_type == "cuda" else "gloo"


def local_rank() -> int:
    """The launcher's ``LOCAL_RANK`` (0 without one)."""
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def launched() -> bool:
    """True in a process started by a launcher (``WORLD_SIZE`` set) or one
    that has joined a process group."""
    return dist.is_initialized() or bool(os.environ.get("WORLD_SIZE"))


def world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    device_type: Optional[str] = None,
    timeout: Optional[float] = None,
) -> bool:
    """Join the process group if this is a multi-process job.

    ``coordinator_address`` is ``host:port`` (a TCP rendezvous) or an init
    URL (``tcp://...``, ``file://...``); it, ``num_processes`` and
    ``process_id`` come from the arguments or from the launcher's
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.
    ``local_device_ids`` (or ``LOCAL_RANK``) picks this rank's CUDA device.
    ``timeout`` (seconds) bounds every collective of the group. Single-process
    jobs are a no-op; idempotent. Returns True iff the group is (already)
    joined.
    """
    global _INITIALIZED
    if _INITIALIZED or dist.is_initialized():
        _INITIALIZED = True
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    explicit = coordinator_address is not None and num_processes is not None and process_id is not None
    if not explicit:
        # ANY partial explicit config must fail loudly: silently falling
        # back to single-process would split the intended multi-process job
        # into independent single-process jobs with no error anywhere.
        partial = [name for name, v in (("coordinator_address", coordinator_address),
                                        ("num_processes", num_processes), ("process_id", process_id))
                   if v is not None]
        if partial and num_processes != 1:
            missing = {"coordinator_address", "num_processes", "process_id"} - set(partial)
            raise ValueError(
                f"Partial multi-process config (got {', '.join(partial)}; missing {', '.join(sorted(missing))}): "
                "set all of coordinator_address + num_processes + process_id (args or "
                "MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them)."
            )
        return False  # single-process: nothing to join
    device_type = device_type or default_device_type()
    if device_type == "cuda":
        torch.cuda.set_device(local_device_ids[0] if local_device_ids else local_rank())
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend_for(device_type), init_method=url, world_size=int(num_processes),
                            rank=int(process_id), **kw)
    _INITIALIZED = True
    return True


def ensure_world(device_type: Optional[str] = None) -> int:
    """The world size, after joining the launcher's group, or, in a single
    process without a launcher, a world-1 group of this process alone (an
    in-memory store: no port, no file)."""
    device_type = device_type or default_device_type()
    if not initialize_multihost(device_type=device_type):
        if device_type == "cuda":
            torch.cuda.set_device(local_rank())
        dist.init_process_group(backend_for(device_type), store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    global _INITIALIZED
    if dist.is_initialized():
        dist.destroy_process_group()
    _INITIALIZED = False


def is_primary_host() -> bool:
    """True on the process that owns host-side singletons (files, progress
    printing, checkpoint pruning): rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _world_max(values) -> torch.Tensor:
    """The elementwise max of every rank's int64 ``values``: an all-reduce
    over the world (on this rank's CUDA device under NCCL)."""
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.cpu()


class PreemptionGuard:
    """Turn termination signals into a cooperative checkpoint request.

    Usage::

        with PreemptionGuard() as guard:
            for step in ...:
                train_step(...)
                if guard.should_checkpoint(step):
                    save_checkpoint(step); break

    ``preempted`` is the local flag (a signal arrived in THIS process);
    ``should_checkpoint()`` is the global decision: the local flags
    OR-reduced over the world, so every rank stops at the same step.
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)) -> None:
        self._signals = tuple(signals)
        self._previous: dict = {}
        self._installed = False
        self.preempted = False

    def _on_signal(self, signum, frame) -> None:  # noqa: ARG002 (signal API)
        self.preempted = True

    def install(self) -> "PreemptionGuard":
        if not self._installed:
            for s in self._signals:
                self._previous[s] = signal.signal(s, self._on_signal)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            for s, prev in self._previous.items():
                signal.signal(s, prev)
            self._previous.clear()
            self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def should_checkpoint(self, step: Optional[int] = None, sync_every: int = 8) -> bool:
        """Global stop decision. Single process: the local flag, every call.
        Several: the OR over the world is a collective, so it runs only when
        ``step % sync_every == 0`` (every rank takes the same branch) and a
        preemption is acted on within ``sync_every`` steps; ``step=None``
        forces the check."""
        if world_size() == 1 or not dist.is_initialized():
            return self.preempted
        if step is not None and step % sync_every != 0:
            return False
        return bool(_world_max([self.preempted])[0])


def all_hosts_agree(value: int) -> bool:
    """True iff every process passes the same value (a config or step check
    before collective phases)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return True
    hi, neg_lo = _world_max([value, -int(value)]).tolist()
    return hi == -neg_lo


# The server's channel: its keys in the store, how often a waiting rank looks
# at the store, and how long a rank whose part of a unit is done waits for
# the others' reports before it counts the server as broken.
_CHANNEL_KEYS = "mvt/serve/"
_CHANNEL_POLL_S = 0.02
_REPORT_TIMEOUT_S = 3600.0


class WorkChannel:
    """Numbered messages from rank 0 to the other ranks, and every rank's
    report of the unit of work a message starts, through the default group's
    key-value store (JSON values under ``_CHANNEL_KEYS``).

    Rank 0 :meth:`publish`-es a message; every other rank :meth:`receive`-s
    the messages in order. Each rank, rank 0 too, runs its part of the unit
    through :meth:`run`, which returns once every rank has reported, so one
    unit never overlaps the next. While a rank runs its part, a watcher
    thread reads the others' reports: when one reports a failure, the
    rank's collectives on ``meshes`` are cancelled (parallel/collectives.py:
    :func:`cancel`), so no rank waits at a collective for a peer that has
    left the unit; after a failed unit every rank renews the groups
    (:func:`renew`) and the next unit starts on fresh ones. A rank waiting
    for its next message polls the store and sits at no collective, so an
    idle server has no collective timeout to meet."""

    def __init__(self, meshes: Sequence = ()) -> None:
        from torch.distributed.distributed_c10d import _get_default_store

        self.store = _get_default_store()
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.meshes = list(meshes)  # the MeshGroups whose collectives a unit runs
        self.seq = 0

    def _key(self, seq: int, rank: Optional[int] = None) -> str:
        return f"{_CHANNEL_KEYS}{seq}" + ("" if rank is None else f"/rank{rank}")

    def publish(self, message: dict) -> int:
        """Rank 0: post the next message; returns its number."""
        seq, self.seq = self.seq, self.seq + 1
        self.store.set(self._key(seq), json.dumps(message))
        return seq

    def receive(self) -> Tuple[int, dict]:
        """Another rank: the next message (waits for it) and its number."""
        seq, self.seq = self.seq, self.seq + 1
        while not self.store.check([self._key(seq)]):
            time.sleep(_CHANNEL_POLL_S)
        return seq, json.loads(self.store.get(self._key(seq)))

    def run(self, seq: int, fn) -> Tuple[object, Optional[BaseException], list]:
        """This rank's part of unit ``seq``: ``fn()`` under the watcher, this
        rank's report, then every rank's (waited for up to
        ``_REPORT_TIMEOUT_S``; a rank that reports nothing raises, and the
        server is broken). Returns ``fn``'s value, its exception here (or
        None) and the other ranks' failures as "rank r: ..." texts."""
        from mlx_video_tpu_torch.parallel import collectives

        done = threading.Event()
        watcher = threading.Thread(target=self._watch, args=(seq, done), daemon=True)
        watcher.start()
        value, error = None, None
        try:
            value = fn()
        except Exception as e:  # noqa: BLE001 — reported to every rank
            error = e
        finally:
            done.set()
            watcher.join()
        self.store.set(self._key(seq, self.rank), "" if error is None else f"{type(error).__name__}: {error}")
        deadline = time.monotonic() + _REPORT_TIMEOUT_S
        reports = {}
        for r in range(self.world):
            while not self.store.check([self._key(seq, r)]):
                if time.monotonic() > deadline:
                    raise RuntimeError(f"rank {r} reported nothing on unit {seq} in {_REPORT_TIMEOUT_S} s")
                time.sleep(_CHANNEL_POLL_S)
            reports[r] = self.store.get(self._key(seq, r)).decode()
        if any(reports.values()):  # every rank read the same reports: all renew, or none
            collectives.renew(self.meshes)
        if self.rank == 0 and seq > 0:  # every rank is done with the unit before this one
            for key in [self._key(seq - 1)] + [self._key(seq - 1, r) for r in range(self.world)]:
                self.store.delete_key(key)
        return value, error, [f"rank {r}: {t}" for r, t in reports.items() if t and r != self.rank]

    def _watch(self, seq: int, done: threading.Event) -> None:
        from mlx_video_tpu_torch.parallel import collectives

        keys = [self._key(seq, r) for r in range(self.world) if r != self.rank]
        while not done.wait(_CHANNEL_POLL_S):
            if any(self.store.check([k]) and self.store.get(k) for k in keys):
                collectives.cancel(self.meshes)
                return
