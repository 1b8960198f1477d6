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

A model sharded over a mesh (trainer/trainer.py with ``mesh_shape``) saves
the same file: its shards and moments are gathered whole one tensor at a
time into the writing rank's host memory, as JAX's ``process_allgather``
gathers to the host (``shards`` = (specs, mesh); every rank takes part, one
writes), and a resume under a
mesh loads the whole tensors and keeps each rank's slices of them.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Optional

import torch

from mlx_video_tpu_torch.io.safetensors import SafetensorsReader, save_safetensors
from mlx_video_tpu_torch.parallel.sharding import local_slice, spec_of, unshard
from mlx_video_tpu_torch.trainer.train_step import AdamWState


def gather_whole(tensors: Dict[str, torch.Tensor], shards=None, keep: bool = True) -> Dict[str, torch.Tensor]:
    """``tensors`` whole. Without ``shards``, the tensors themselves
    (detached). Under ``shards`` = (specs, mesh) each is all-gathered alone
    (every rank takes part) and moved to the host at once by a rank that
    ``keep``s it, so no rank holds more than one whole tensor on its device;
    a rank that does not keep them gets an empty dict."""
    if shards is None:
        return {k: t.detach() for k, t in tensors.items()} if keep else {}
    specs, mesh = shards
    out = {}
    with torch.no_grad():
        for name, t in tensors.items():
            whole = unshard(t.detach(), spec_of(specs, name), mesh)
            if keep:
                out[name] = whole.cpu()
            del whole
    return out


def save_train_checkpoint(
    path: Path, params: Dict[str, torch.Tensor], opt_state: AdamWState, step: int, shards=None, write: bool = True
) -> Dict[str, torch.Tensor]:
    """Write the trainable tensors, the AdamW state and the step to ``path``;
    ``shards`` = (specs, mesh) gathers a sharded model's whole first
    (:func:`gather_whole`), and only a rank with ``write`` writes. Returns
    the whole trainables that were written (empty where ``write`` is off),
    so that the adapter or transformer file is made from the same gather."""
    whole = gather_whole(params, shards, write)
    mu, nu = gather_whole(opt_state.mu, shards, write), gather_whole(opt_state.nu, shards, write)
    if write:
        tensors = {f"params.{k}": t for k, t in whole.items()}
        tensors.update({f"opt.mu.{k}": t for k, t in mu.items()})
        tensors.update({f"opt.nu.{k}": t for k, t in nu.items()})
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        save_safetensors(path, tensors, metadata={"step": str(step), "opt_count": str(opt_state.count)})
    return whole


def load_train_checkpoint(path: Path, params: Dict[str, torch.Tensor], opt_state: AdamWState, shards=None) -> int:
    """Copy a saved state into ``params`` and ``opt_state`` in place (names
    and shapes must match; ``shards`` = (specs, mesh): this rank's slices of
    the saved whole tensors); returns the step."""
    def local(name, t):
        return t if shards is None else local_slice(t, spec_of(shards[0], name), shards[1], name)

    with SafetensorsReader(path) as r:
        expected = {f"params.{k}" for k in params} | {f"opt.{m}.{k}" for m in ("mu", "nu") for k in params}
        if set(r.keys()) != expected:
            raise ValueError(f"{path}: the state's tensors {sorted(set(r.keys()) ^ expected)[:10]} do not match "
                             "the trainable parameters")
        with torch.no_grad():
            for k, p in params.items():
                for target, key in ((p, f"params.{k}"), (opt_state.mu[k], f"opt.mu.{k}"),
                                    (opt_state.nu[k], f"opt.nu.{k}")):
                    saved = local(k, r.get(key, target.device))
                    if saved.shape != target.shape:
                        raise ValueError(f"{path}: {key} {r.shape(key)} (this rank's part {tuple(saved.shape)}) "
                                         f"!= {tuple(target.shape)}")
                    target.copy_(saved)
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
