"""Phase timing, device memory lines, device traces, and the event stream
of machine-readable progress events for a UI and in-process subscribers.

Counterpart of mlx_video_tpu/utils/profiling.py. The event half
(``add_event_sink``, ``remove_event_sink``, ``has_event_sinks``,
``ui_event``, ``progress_echo_enabled``, ``step_event``): a payload goes to
stdout as one ``MLX_VIDEO_UI_EVENT {json}`` line when
``MLX_VIDEO_UI_JSON=1``, and to every subscribed sink (the server's
streaming endpoint) always. The pipeline asks :func:`progress_echo_enabled`
before it builds a step event, so a run with neither a sink nor either
variable pays nothing for them. The timing half: :class:`PhaseTimer` (the
``phase`` events, seconds ended by a device synchronise on CUDA),
:func:`log_memory` (the CUDA allocator's bytes) and :func:`device_trace`, a
``torch.profiler`` trace where the JAX package takes a ``jax.profiler`` one
(``tpu_trace``).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Union

import torch

_SINKS: list = []
_SINKS_LOCK = threading.Lock()


def add_event_sink(fn) -> None:
    with _SINKS_LOCK:
        _SINKS.append(fn)


def remove_event_sink(fn) -> None:
    with _SINKS_LOCK:
        if fn in _SINKS:
            _SINKS.remove(fn)


def has_event_sinks() -> bool:
    """Whether anything subscribes in-process: producers of costly payloads
    (a preview JPEG) check before building one."""
    return bool(_SINKS)


def ui_event(payload: dict) -> None:
    """One event: a stdout line under ``MLX_VIDEO_UI_JSON=1``, and every
    sink (a sink that raises is skipped, the others still get it)."""
    if os.environ.get("MLX_VIDEO_UI_JSON") == "1":
        print("MLX_VIDEO_UI_EVENT " + json.dumps(payload), flush=True)
    if _SINKS:
        with _SINKS_LOCK:
            sinks = list(_SINKS)
        for fn in sinks:
            try:
                fn(payload)
            except Exception:  # noqa: BLE001 — a dead sink must not stop the events
                pass


def progress_echo_enabled() -> bool:
    """Whether per-step denoise progress is wanted: ``MLX_VIDEO_UI_JSON=1``,
    ``MLX_VIDEO_PROGRESS_ECHO=1`` or a subscribed sink."""
    return (
        os.environ.get("MLX_VIDEO_UI_JSON") == "1"
        or os.environ.get("MLX_VIDEO_PROGRESS_ECHO") == "1"
        or bool(_SINKS)
    )


def step_event(step: int, total: int, sigma: Optional[float] = None) -> None:
    """A denoise step's event ``{"kind": "denoise_step", "step", "total",
    "sigma"}``; with ``MLX_VIDEO_PROGRESS_ECHO=1`` also a plain progress line
    every ``MLX_VIDEO_PROGRESS_ECHO_EVERY`` steps and at the last."""
    if os.environ.get("MLX_VIDEO_PROGRESS_ECHO") == "1":
        try:
            every = int(os.environ.get("MLX_VIDEO_PROGRESS_ECHO_EVERY", "1") or 1)
        except ValueError:
            every = 1
        if step % every == 0 or step == total:
            extra = f" sigma={sigma:.4f}" if sigma is not None else ""
            print(f"progress: denoise step {step}/{total}{extra}", flush=True)
    payload = {"kind": "denoise_step", "step": step, "total": total}
    if sigma is not None:
        payload["sigma"] = sigma
    ui_event(payload)


class PhaseTimer:
    """Wall seconds per named phase: a repeated name accumulates, the names
    keep their first-seen order, and each phase sends a ``phase`` event with
    its own seconds. On a CUDA ``device`` a phase ends with a synchronise,
    so its seconds hold the device work it queued."""

    def __init__(self, device: Union[str, torch.device, None] = None) -> None:
        self.phases: Dict[str, float] = {}
        self._order: list = []
        self._device = None if device is None else torch.device(device)

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self._device is not None and self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            elapsed = time.perf_counter() - start
            if name not in self.phases:
                self._order.append(name)
            self.phases[name] = self.phases.get(name, 0.0) + elapsed
            ui_event({"kind": "phase", "phase": name, "seconds": elapsed})

    @property
    def total(self) -> float:
        return sum(self.phases.values())

    def report(self, file=None) -> None:
        file = file or sys.stdout
        print("\nPhase timing:", file=file)
        for name in self._order:
            secs = self.phases[name]
            pct = 100.0 * secs / self.total if self.total else 0.0
            print(f"  {name:<24} {secs:8.2f}s  {pct:5.1f}%", file=file)
        print(f"  {'total':<24} {self.total:8.2f}s", file=file)

    def dump_json(self, path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"phases": self.phases, "total": self.total}, f, indent=2)


def _default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def log_memory(stage: str, enabled: bool = True, file=None, device=None) -> None:
    """One line ``Memory (<stage>): in_use=…GB peak=…GB limit=…GB`` on
    stderr (or ``file``): on a CUDA ``device`` (default: the card when there
    is one) the allocator's bytes in use, its peak and the card's total
    memory; on the CPU zeros, as the JAX function prints on its CPU backend
    (whose device keeps no memory statistics)."""
    if not enabled:
        return
    device = _default_device() if device is None else torch.device(device)
    in_use = peak = limit = 0.0
    if device.type == "cuda":
        in_use = torch.cuda.memory_allocated(device) / 1024**3
        peak = torch.cuda.max_memory_allocated(device) / 1024**3
        limit = torch.cuda.get_device_properties(device).total_memory / 1024**3
    print(f"Memory ({stage}): in_use={in_use:.2f}GB peak={peak:.2f}GB limit={limit:.2f}GB",
          file=file or sys.stderr)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str], device=None):
    """A ``torch.profiler`` trace of the block, written as a Chrome trace
    ``trace.<pid>.<ns>.json`` into ``trace_dir`` (made if missing); nothing
    without ``trace_dir``. It records the CUDA activity on a CUDA ``device``
    (default: the card when there is one), else the CPU activity."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    device = _default_device() if device is None else torch.device(device)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    activity = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(out / f"trace.{os.getpid()}.{time.time_ns()}.json"))
