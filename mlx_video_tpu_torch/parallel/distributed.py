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

Nothing here falls back: a failed init or collective raises.
"""

from __future__ import annotations

import datetime
import os
import signal
from typing import Optional, Sequence

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
