"""Trainer helpers: progress line, config display, device memory, seed,
quantization metadata and video IO.

Counterpart of mlx_video_tpu/trainer/aux.py: ``ProgressStats``,
``TrainingProgress`` and ``print_config`` are the port's own copies,
unchanged in behaviour; ``read_video`` and ``save_video`` run on the port's
io/media.py; ``log_device_memory`` reads the CUDA allocator;
``set_seed`` seeds torch and returns a ``torch.Generator``;
``read_quantization_metadata`` is loading.py's. Captioning (a BLIP model
from the hub) and the hub push need the network and are not ported:
``caption_image``, ``caption_video`` and ``push_to_hub`` raise by name.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from mlx_video_tpu_torch.loading import read_quantization_metadata  # noqa: F401  (re-exported)


@dataclasses.dataclass
class ProgressStats:
    step: int
    total: int
    loss: float
    step_time: float


class TrainingProgress:
    """Minimal terminal progress line."""

    def __init__(self, total: int, enabled: bool = True):
        self.total = total
        self.enabled = enabled
        self._start = time.time()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.enabled:
            sys.stderr.write("\n")

    def update(self, stats: ProgressStats) -> None:
        if not self.enabled:
            return
        done = stats.step + 1
        eta = (time.time() - self._start) / max(done, 1) * max(self.total - done, 0)
        sys.stderr.write(
            f"\rstep {done}/{self.total} loss={stats.loss:.4f} "
            f"{stats.step_time:.2f}s/step eta={eta:.0f}s   "
        )
        sys.stderr.flush()


def print_config(cfg, file=None) -> None:
    file = file or sys.stdout
    print("Training configuration:", file=file)
    for field in dataclasses.fields(cfg):
        value = getattr(cfg, field.name)
        if value is not None and value != field.default:
            print(f"  {field.name}: {value}", file=file)


def log_device_memory(stage: str = "") -> None:
    """Print the CUDA allocator's current and peak bytes (nothing without
    CUDA)."""
    if not torch.cuda.is_available():
        return
    gib = 2**30
    print(f"[memory] {stage}: {torch.cuda.memory_allocated() / gib:.3f} GiB allocated, "
          f"peak {torch.cuda.max_memory_allocated() / gib:.3f} GiB", flush=True)


def set_seed(seed: int) -> torch.Generator:
    """Seed torch's global generators and return a host generator seeded
    with ``seed`` (the JAX function returns ``jax.random.key(seed)``)."""
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def _needs_network(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} needs the network (a model or repo on the hub) and is not ported to "
                               "mlx_video_tpu_torch")


def push_to_hub(output_dir: Path, model_id: str, token: Optional[str] = None) -> None:
    raise _needs_network("push_to_hub")


def caption_image(image, model_name: str = "Salesforce/blip-image-captioning-base",
                  max_new_tokens: Optional[int] = None) -> str:
    raise _needs_network("caption_image (automatic captioning)")


def caption_video(video_path: Path, model_name: str = "Salesforce/blip-image-captioning-base") -> str:
    raise _needs_network("caption_video (automatic captioning)")


def read_video(path: Path, frame_cap: Optional[int] = None):
    from mlx_video_tpu_torch.io.media import load_video

    return load_video(path, frame_cap=frame_cap)


def save_video(path: Path, frames, fps: float = 24.0) -> None:
    import numpy as np

    from mlx_video_tpu_torch.io.media import VideoWriter

    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    with VideoWriter(path, frames.shape[2], frames.shape[1], fps) as w:
        w.write(frames)
