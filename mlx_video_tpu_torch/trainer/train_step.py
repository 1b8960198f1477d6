"""Training step and optimizer: the learning-rate schedules, AdamW with a
global-norm clip, the gradient step, accumulation and the update.

Counterpart of mlx_video_tpu/trainer/train_step.py (``make_lr_schedule``,
``make_optimizer``, ``grad_step``, ``accumulate_grads``, ``apply_updates``),
with optax's arithmetic written out so the numbers match it:
- the schedules are optax's ``linear_schedule(lr, 0, N)`` and
  ``cosine_decay_schedule(lr, N, alpha=0)``, read at the optimizer's update
  count (0 for the first update);
- ``clip_by_global_norm``: the norm is taken over the trainable tensors only
  (the JAX package masks the frozen base out with ``multi_transform``), and a
  gradient is scaled by ``max_norm / norm`` with no epsilon when the norm
  reaches ``max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
  norm + 1e-6, so it is not used);
- ``adamw``: bias-corrected moments in the parameter's dtype, eps 1e-8 outside
  the square root, and weight decay added to the update (decoupled), times
  -lr.

Only the trainable tensors have gradients and optimizer state; the frozen base
never has either. Updates are in place. The JAX package's layout-stable and
fused-step machinery is not ported (it exists for XLA layouts).

A model sharded over a mesh (parallel/sharding.py; JAX shards the
parameters and ``opt_state_specs`` the moments alike): each rank holds its
shards, their gradients and AdamW moments of the same shapes, and updates
them in place. Every rank computes the whole loss (the sharded forward
gathers the velocities); the step differentiates it divided by the
data x fsdp ranks that compute it alike, so the gathers' reduce-scatters
(``fsdp`` cuts: a gradient summed to its shard's owner) and the sum over
``data`` and ``fsdp`` of what a rank holds whole (:func:`sync_grads`) give
the whole gradient; the ``tensor`` axis is Megatron's (ops/linear.py), each
rank's gradients already whole there. The clip's norm counts every shard
once (:func:`global_norm_sq`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from mlx_video_tpu_torch.config import LTXModelConfig
from mlx_video_tpu_torch.models.ltx.model import LTXModel
from mlx_video_tpu_torch.trainer.strategies import Draws, StrategyBatch, strategy_loss_fn

Schedule = Union[float, Callable[[int], float]]


def make_lr_schedule(scheduler_type: str, lr: float, total_steps: int) -> Schedule:
    """constant / linear / cosine, as optax builds them for the JAX trainer."""
    sched = (scheduler_type or "constant").lower()
    n = max(1, total_steps)
    if sched == "linear":
        return lambda count: lr * (1.0 - min(max(count, 0), n) / n)
    if sched == "cosine":
        return lambda count: lr * 0.5 * (1.0 + math.cos(math.pi * min(count, n) / n))
    return lr


@dataclass
class AdamWState:
    count: int = 0  # updates applied so far
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)


@dataclass(frozen=True)
class AdamW:
    """optax ``chain(clip_by_global_norm(max_grad_norm), adamw(...))``."""

    learning_rate: Schedule = 1e-4
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def lr_at(self, count: int) -> float:
        return self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        return AdamWState(
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], state: AdamWState, grads: Dict[str, torch.Tensor],
               shards=None) -> None:
        """Clip, then one AdamW step on ``params`` and ``state``, in place.
        ``shards``: (specs, mesh) of a sharded model, whose norm counts every
        shard once."""
        if self.max_grad_norm is not None and self.max_grad_norm > 0:
            if shards is not None and _spans_ranks(shards[1]):
                norm = torch.sqrt(global_norm_sq(grads, *shards))
            else:
                norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
            clip = norm >= self.max_grad_norm
            grads = {k: torch.where(clip, g / norm.to(g.dtype) * self.max_grad_norm, g) for k, g in grads.items()}
        lr = self.lr_at(state.count)
        step = state.count + 1
        c1, c2 = 1.0 - self.b1**step, 1.0 - self.b2**step
        for k, p in params.items():
            g, mu, nu = grads[k], state.mu[k], state.nu[k]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.weight_decay * p
            p.add_(u.to(p.dtype), alpha=-lr)
        state.count = step


def make_optimizer(
    learning_rate: Schedule = 1e-4,
    weight_decay: float = 0.01,
    max_grad_norm: float = 1.0,
    b1: float = 0.9,
    b2: float = 0.999,
) -> AdamW:
    """AdamW with global-norm clipping (none when ``max_grad_norm`` is None
    or not positive), over the tensors it is given: the trainer gives it the
    trainable ones only."""
    return AdamW(learning_rate, weight_decay, max_grad_norm, b1, b2)


def _spans_ranks(mesh) -> bool:
    return any(mesh.size(a) > 1 for a in mesh.axes)


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _spec_axes(specs, name: str, mesh) -> Tuple[str, ...]:
    from mlx_video_tpu_torch.parallel.sharding import spec_of

    cut = {a for entry in spec_of(specs, name) for a in _axes(entry)}
    return tuple(a for a in mesh.axes if a in cut and mesh.size(a) > 1)


def _bucketed(tensors: Dict[str, torch.Tensor], key) -> Dict[tuple, list]:
    buckets: Dict[tuple, list] = {}
    for name, t in tensors.items():
        buckets.setdefault(key(name, t), []).append(name)
    return buckets


def sync_grads(grads: Dict[str, torch.Tensor], specs, mesh) -> Dict[str, torch.Tensor]:
    """Sum each gradient over the ``data`` and ``fsdp`` ranks whose copies of
    its tensor are one (the axes its spec does not cut): one all-reduce per
    set of axes and dtype, over the flattened group."""
    def key(name, g):
        cut = _spec_axes(specs, name, mesh)
        return tuple(a for a in ("data", "fsdp") if a not in cut and mesh.size(a) > 1), g.dtype

    out = dict(grads)
    for (axes, _), names in _bucketed(grads, key).items():
        if not axes:
            continue
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        flat = mesh.flat(axes).all_reduce(flat)
        for n, part in zip(names, flat.split([grads[n].numel() for n in names])):
            out[n] = part.view_as(grads[n])
    return out


def global_norm_sq(grads: Dict[str, torch.Tensor], specs, mesh) -> torch.Tensor:
    """The squared global norm of a sharded model's gradients (fp32): each
    rank's sum of squares of its shards, summed over the axes that cut them,
    so every shard counts once."""
    total = None
    for axes, names in _bucketed(grads, lambda name, g: _spec_axes(specs, name, mesh)).items():
        part = mesh.flat(axes).all_reduce(sum(torch.sum(grads[n].float() ** 2) for n in names).reshape(1))[0]
        total = part if total is None else total + part
    return total


def grad_step(
    model: LTXModel,
    params: Dict[str, torch.Tensor],
    sb: StrategyBatch,
    draws: Draws,
    config: LTXModelConfig,
    sp=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One microbatch: the loss and the gradients of ``params`` (the
    trainable tensors of ``model``, by name); no update. Gradients are on
    inside, whatever the caller's grad mode. A sharded model's: the
    gradients of this rank's shards (the module docstring), ``sp`` its
    sequence parallelism."""
    mesh = getattr(model, "mesh", None)
    alike = 1 if mesh is None else mesh.size("data") * mesh.size("fsdp")
    with torch.enable_grad():
        loss = strategy_loss_fn(model, config, sb, draws, sp=sp)
        grads = torch.autograd.grad(loss / alike if alike > 1 else loss, list(params.values()))
    grads = dict(zip(params, grads))
    if mesh is not None and _spans_ranks(mesh):
        grads = sync_grads(grads, model.shard_specs, mesh)
    return loss.detach(), grads


def accumulate_grads(acc: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """acc + grads, in place in ``acc``."""
    for k, g in grads.items():
        acc[k].add_(g)
    return acc


def apply_updates(
    params: Dict[str, torch.Tensor],
    opt_state: AdamWState,
    grads: Dict[str, torch.Tensor],
    optimizer: AdamW,
    accum_steps: int = 1,
    shards=None,
) -> None:
    """Average accumulated gradients over ``accum_steps``, then clip and
    update ``params`` and ``opt_state`` in place (``shards``: AdamW.update's)."""
    if accum_steps > 1:
        grads = {k: g / accum_steps for k, g in grads.items()}
    optimizer.update(params, opt_state, grads, shards)
