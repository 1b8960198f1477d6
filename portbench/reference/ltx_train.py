"""Plain PyTorch reference of LoRA training steps on the video DiT.

What it recomputes from the benchmark's own inputs (the drawn base weights,
the clips it wrote, the recipe and the seed), following the port's trainer
(trainer/trainer.py, strategies.py, train_step.py, lora.py, datasets.py at
commit c91ea08) and, through it, the reference trainer's recipe:
- the factors: every to_q, to_k, to_v, to_out, ff.proj_in and ff.proj_out of
  every block, A ~ N(0, 0.01) (rank, in) drawn in module order from a CPU
  generator seeded with the seed, B = 0, scale alpha / rank;
- the clip of step k: epoch k // n's permutation of the n clips
  (numpy ``default_rng(seed + epoch)``), batch size one;
- the draws of step k, from a generator seeded by numpy's
  ``SeedSequence([seed, k])``: the shifted logit-normal sigma, the
  first-frame keep (p), the noise;
- flow matching: x_t = (1 - s) x + s eps, target eps - x, the first frame's
  tokens clean at timestep 0 and out of the loss where kept; the loss the
  token-masked mean of the channel-summed squared error, fp32;
- the DiT in bf16 with the factors' delta in fp32 (portbench/reference/
  ltx_video.py), each block recomputed in the backward;
- optax's chain of a global-norm clip and AdamW (bias-corrected moments,
  eps outside the root, decoupled weight decay) at a cosine rate over the
  recipe's steps.

It imports torch and numpy only. ``lowp=True``: float8 operands in every
linear, the control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.ltx_video import DiT, split_rope_tables, position_grid

TARGETS = ("attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out",
           "attn2.to_q", "attn2.to_k", "attn2.to_v", "attn2.to_out", "ff.proj_in", "ff.proj_out")


def lora_init(weights: Dict[str, torch.Tensor], cfg: dict, rank: int, seed: int, device) -> Dict[str, Tuple]:
    """{linear: (A, B)} fp32 on ``device``, requiring gradients."""
    g = torch.Generator().manual_seed(int(seed))
    out = {}
    for i in range(cfg["num_layers"]):
        for t in TARGETS:
            name = f"blocks.{i}.{t}"
            bias = weights[name + ".bias"]
            out_dim = bias.shape[0]
            in_dim = (weights[name + ".weight"].shape[1] if name + ".weight" in weights
                      else weights[name + ".quant_weight"].shape[1] * 32 // cfg["quant"]["bits"])
            a = torch.randn((rank, in_dim), generator=g, dtype=torch.float32) * 0.01
            out[name] = (a.to(device).requires_grad_(), torch.zeros((out_dim, rank), device=device,
                                                                    requires_grad=True))
    return out


def clip_of_step(step: int, n: int, seed: int) -> int:
    idxs = np.arange(n)
    np.random.default_rng(int(seed) + step // n).shuffle(idxs)
    return int(idxs[step % n])


def step_generator(seed: int, step: int, device) -> torch.Generator:
    derived = int(np.random.SeedSequence([int(seed), step]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(derived)


def draws(gen: torch.Generator, tokens: int, channels: int, p: float, std: float):
    """(sigma (1,), keep (1, 1) bool, noise (1, S, C)) in the generator's
    order."""
    m = (2.05 - 0.95) / (4096 - 1024)
    shift = m * tokens + (0.95 - m * 1024)
    sigma = torch.sigmoid(torch.randn((1,), generator=gen, device=gen.device) * std + shift)
    keep = torch.rand((1, 1), generator=gen, device=gen.device) < p
    noise = torch.randn((1, tokens, channels), generator=gen, device=gen.device)
    return sigma, keep, noise


def step_loss(dit: DiT, latents: torch.Tensor, context: torch.Tensor, mask: torch.Tensor, pe, dr) -> torch.Tensor:
    """One clip's flow-matching loss: latents (1, C, F, H, W) fp32,
    context (1, L, D) fp32, mask (1, L) bool."""
    sigma, keep, noise = dr
    b, c, f, h, w = latents.shape
    x = latents.permute(0, 2, 3, 4, 1).reshape(b, f * h * w, c)
    first = torch.zeros((b, f, h, w), dtype=torch.bool, device=x.device)
    first[:, 0] = True
    cond = first.reshape(b, -1) & keep
    s = sigma[:, None, None]
    noisy = torch.where(cond[..., None], x, (1.0 - s) * x + s * noise)
    target = torch.where(cond[..., None], torch.zeros_like(x), noise - x)
    ts = torch.where(cond, torch.zeros((), device=x.device), sigma[:, None].expand(b, x.shape[1]))
    dt = torch.bfloat16
    pred = dit.forward(noisy.to(dt), ts.to(dt), context.to(dt), pe, context_mask=mask)
    err = torch.sum(torch.square(pred.float() - target), dim=-1)
    keep_tokens = ~cond
    return torch.where(keep_tokens, err, torch.zeros((), device=err.device)).sum() / keep_tokens.sum().clamp(min=1)


class AdamW:
    """optax chain(clip_by_global_norm(max_norm), adamw(lr schedule, b1, b2,
    eps, weight_decay)), updating the factors in place."""

    def __init__(self, params: List[torch.Tensor], lr: float, total: int, weight_decay: float, max_norm: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.total = params, lr, max(1, total)
        self.wd, self.max_norm, self.b1, self.b2, self.eps = weight_decay, max_norm, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        if float(norm) >= self.max_norm:
            grads = [g / norm * self.max_norm for g in grads]
        lr = self.lr * 0.5 * (1.0 + math.cos(math.pi * min(self.count, self.total) / self.total))
        step = self.count + 1
        c1, c2 = 1.0 - self.b1 ** step, 1.0 - self.b2 ** step
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.add_((mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.wd * p, alpha=-lr)
        self.count = step


def train_steps(weights: Dict[str, torch.Tensor], cfg: dict, recipe: dict, clips: Sequence[dict], seed: int,
                steps: int, device, lowp: bool = False) -> dict:
    """``steps`` LoRA steps from the start. Returns the losses, each factor's
    first gradient as the optimizer takes it (after the clip) and each
    factor's change over the steps, by name (``<linear>.lora_A`` /
    ``.lora_B``), all on the host."""
    lora = lora_init(weights, cfg, recipe["lora_rank"], seed, device)
    dit = DiT(weights, cfg, lowp=lowp, lora=lora, lora_scale=recipe["lora_alpha"] / recipe["lora_rank"], remat=True)
    names = [f"{n}.lora_{w}" for n in lora for w in ("A", "B")]
    params = [t for pair in lora.values() for t in pair]
    start = [p.detach().clone() for p in params]
    opt = AdamW(params, recipe["lr"], recipe["steps"], recipe["weight_decay"], recipe["max_grad_norm"])
    lat0 = clips[0]["latents"]
    f, h, w = lat0.shape[-3:]
    pe = split_rope_tables(position_grid(1, f, h, w).to(device), dit.dim, dit.heads,
                           cfg["positional_embedding_theta"], cfg["positional_embedding_max_pos"])
    losses, first = [], None
    for k in range(steps):
        clip = clips[clip_of_step(k, len(clips), seed)]
        latents = clip["latents"].to(device)
        dr = draws(step_generator(seed, k, device), f * h * w, latents.shape[1],
                   recipe["first_frame_conditioning_p"], recipe["timestep_sampling_std"])
        with torch.enable_grad():
            loss = step_loss(dit, latents, clip["context"].to(device), clip["mask"].to(device), pe, dr)
            grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        opt.update(list(grads))
        if first is None:
            first = {n: float(torch.linalg.vector_norm(mu.float()) / (1.0 - opt.b1)) for n, mu in zip(names, opt.mu)}
    change = {n: float(torch.linalg.vector_norm((p.detach() - p0).float())) for n, p, p0 in zip(names, params, start)}
    return {"losses": losses, "first_grad": first, "change": change}
