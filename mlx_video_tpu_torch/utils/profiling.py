"""The event stream: machine-readable progress events for a UI and for
in-process subscribers.

Counterpart of the event half of mlx_video_tpu/utils/profiling.py
(``add_event_sink``, ``remove_event_sink``, ``has_event_sinks``,
``ui_event``, ``progress_echo_enabled``, ``step_event``); the ``phase``
event its phase timer sends comes from pipelines/generate.py's ``_phase``. A payload goes to stdout as one
``MLX_VIDEO_UI_EVENT {json}`` line when ``MLX_VIDEO_UI_JSON=1``, and to
every subscribed sink (the server's streaming endpoint) always. The
pipeline asks :func:`progress_echo_enabled` before it builds a step event,
so a run with neither a sink nor either variable pays nothing for them.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

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
