"""Resumable training state: the trainable tensors, the optimizer state and
the step, in one safetensors file, plus pruning and finding the newest.

Counterpart of mlx_video_tpu/trainer/checkpoints.py, with one deliberate
difference: the JAX state file holds the whole parameter tree, the frozen base
included (26 GB for each save of a LoRA run on the bf16 19B), while this one
holds only what training changes. Resume loads the base again from the
model's own files (``model_repo``) and then this state over it. Tensors are
stored under their names (``params.<name>``, ``opt.mu.<name>``,
``opt.nu.<name>``) with the step and the optimizer's update count in the
metadata.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Optional

import torch

from mlx_video_tpu_torch.io.safetensors import SafetensorsReader, save_safetensors
from mlx_video_tpu_torch.trainer.train_step import AdamWState


def save_train_checkpoint(
    path: Path, params: Dict[str, torch.Tensor], opt_state: AdamWState, step: int
) -> None:
    """Write the trainable tensors, the AdamW state and the step to ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tensors = {f"params.{k}": p.detach() for k, p in params.items()}
    tensors.update({f"opt.mu.{k}": t for k, t in opt_state.mu.items()})
    tensors.update({f"opt.nu.{k}": t for k, t in opt_state.nu.items()})
    save_safetensors(path, tensors, metadata={"step": str(step), "opt_count": str(opt_state.count)})


def load_train_checkpoint(path: Path, params: Dict[str, torch.Tensor], opt_state: AdamWState) -> int:
    """Copy a saved state into ``params`` and ``opt_state`` in place (names
    and shapes must match); returns the step."""
    with SafetensorsReader(path) as r:
        expected = {f"params.{k}" for k in params} | {f"opt.{m}.{k}" for m in ("mu", "nu") for k in params}
        if set(r.keys()) != expected:
            raise ValueError(f"{path}: the state's tensors {sorted(set(r.keys()) ^ expected)[:10]} do not match "
                             "the trainable parameters")
        with torch.no_grad():
            for k, p in params.items():
                for target, key in ((p, f"params.{k}"), (opt_state.mu[k], f"opt.mu.{k}"),
                                    (opt_state.nu[k], f"opt.nu.{k}")):
                    if r.shape(key) != tuple(target.shape):
                        raise ValueError(f"{path}: {key} {r.shape(key)} != {tuple(target.shape)}")
                    target.copy_(r.get(key, target.device))
        opt_state.count = int(r.metadata.get("opt_count", "0"))
        return int(r.metadata.get("step", "0"))


def prune_checkpoints(output_dir: Path, keep_last_n: int) -> None:
    """Keep the newest N checkpoint steps; every file of an older step goes.
    Files without a ``step_<n>`` marker are never touched."""
    if keep_last_n is None or keep_last_n < 0:
        return
    by_step: dict = {}
    for f in Path(output_dir).glob("*.safetensors"):
        step = _step_of(f.name)
        if step >= 0:
            by_step.setdefault(step, []).append(f)
    for step in sorted(by_step)[: max(0, len(by_step) - keep_last_n)]:
        for f in by_step[step]:
            f.unlink(missing_ok=True)


def _step_of(name: str) -> int:
    m = re.search(r"step_(\d+)", name)
    return int(m.group(1)) if m else -1


def latest_checkpoint(output_dir: Path, prefix: str = "state_step_") -> Optional[Path]:
    files = sorted(Path(output_dir).glob(f"{prefix}*.safetensors"), key=lambda p: _step_of(p.name))
    return files[-1] if files else None
