"""Driver of the LoRA training traffic: the port's ``Trainer.train()``
(trainer/trainer.py) with the reference trainer's ``ltx2_lora.yaml`` recipe
(rank 8, alpha 16, AdamW at 1e-4 on a cosine over 1000 steps, clip 1.0,
shifted logit-normal sigmas, first-frame conditioning at 0.1, batch 1,
gradient checkpointing), over a precomputed dataset that set-up writes from
the seed into a fresh directory under ``TMPDIR`` (removed at the end).

What a traffic file (``"driver": "lora_train"``) sets: ``clips`` (the
dataset's size), ``latent_shape`` (C, F, H, W), ``caption_positions`` and
``caption_real`` (the positions the mask keeps), ``recipe`` (the
``TrainingConfig`` fields), ``check_steps`` (the first steps the reference
follows) and ``trace_steps`` (the steps of a traced run's one call).

Set-up builds one Trainer over the drawn base weights and drives it through
its first ``check_steps`` steps by ``train()`` itself; it keeps each step's
loss, every factor's first gradient as the optimizer takes it (its first
moment after one update over 1 - b1, read in a wrapper of the optimizer's
``update``) and every factor's change over those steps. The same object
then runs the window: one ``train()`` call of as many steps as the warm
steps' median time says fill ``seconds`` (it ends with the trainer's
final save, as every ``train()`` does).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import shutil
import tempfile
from typing import Dict, List

import numpy as np

from portbench.drivers.distilled import program_bundle
from portbench.reference import ltx_train
from portbench.weights import draw_weights

UNIT = "train_step"


def trainer_seed(seed: int) -> int:
    return int(seed) % 2 ** 31


def write_dataset(root, cfg: dict, traffic: dict, seed: int, device) -> List[dict]:
    """``clips`` seeded clips (latents N(0, 1), caption N(0, 1) with the first
    ``caption_real`` positions kept) as safetensors in the layout
    ``precompute`` writes; returns them as tensors for the reference."""
    import torch

    from mlx_video_tpu_torch.io.safetensors import save_safetensors

    g = torch.Generator(device=device).manual_seed(int(seed) ^ 0xDA7A)
    c, f, h, w = traffic["latent_shape"]
    clips = []
    for sub in ("latents", "conditions"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(traffic["clips"]):
        lat = torch.randn((c, f, h, w), generator=g, device=device).cpu()
        ctx = torch.randn((traffic["caption_positions"], cfg["caption_channels"]), generator=g, device=device).cpu()
        mask = torch.zeros(traffic["caption_positions"], dtype=torch.bool)
        mask[:traffic["caption_real"]] = True
        save_safetensors(os.path.join(root, "latents", f"clip_{i:03d}.safetensors"), {
            "latents": lat, "num_frames": torch.tensor([f], dtype=torch.int32),
            "height": torch.tensor([h], dtype=torch.int32), "width": torch.tensor([w], dtype=torch.int32),
            "fps": torch.tensor([24.0])})
        save_safetensors(os.path.join(root, "conditions", f"clip_{i:03d}.safetensors"),
                         {"video_prompt_embeds": ctx, "prompt_attention_mask": mask})
        clips.append({"latents": lat[None], "context": ctx[None], "mask": mask[None]})
    return clips


class _Watch:
    """The trainer's optimizer, its updates passed through; after the first
    it keeps each factor's first gradient norm (first moment / (1 - b1))."""

    def __init__(self, inner):
        self.inner = inner
        self.first = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def update(self, params, state, grads, shards=None):
        import torch

        self.inner.update(params, state, grads, shards)
        if self.first is None:
            self.first = {k: float(torch.linalg.vector_norm(state.mu[k].float())) / (1.0 - self.inner.b1)
                          for k in params}


def setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    import torch

    from mlx_video_tpu_torch.trainer.config import TrainingConfig
    from mlx_video_tpu_torch.trainer.trainer import Trainer

    weights = draw_weights(cfg, seed, device, parts=())
    work_dir = tempfile.mkdtemp(prefix="portbench_lora_")
    clips = write_dataset(os.path.join(work_dir, "data"), cfg, traffic, seed, device)
    bundle, _ = program_bundle(cfg, {"dit": weights["dit"]}, None, device)
    recipe = dict(traffic["recipe"], seed=trainer_seed(seed), data_root=os.path.join(work_dir, "data"),
                  output_dir=os.path.join(work_dir, "out"), handle_preemption=False)
    tcfg = TrainingConfig(**recipe)
    trainer = Trainer(tcfg, model_config=bundle.transformer_config, params=bundle.transformer, device=device)
    trainer.optimizer = _Watch(trainer.optimizer)
    start = {k: p.detach().clone() for k, p in trainer.params.items()}
    n = traffic["check_steps"]
    trainer.cfg = dataclasses.replace(tcfg, steps=n)
    trainer.train()
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm((p.detach() - start[k]).float())) for k, p in trainer.params.items()}
    del start
    warm = sorted(list(trainer.step_seconds)[1:]) or list(trainer.step_seconds)
    state = {"cfg": cfg, "traffic": traffic, "seed": seed, "device": device, "weights": weights, "clips": clips,
             "work_dir": work_dir, "trainer": trainer, "tcfg": tcfg, "step_s": warm[len(warm) // 2],
             "program": {"losses": list(trainer.loss_history)[:n], "first_grad": trainer.optimizer.first,
                         "change": change}}
    trainer.start_step = n
    return state


def call(state: dict, i: int) -> dict:
    """One ``train()`` call from where the last one stopped: as many steps as
    fill the window (``window_s``, with a tenth to spare) at set-up's step
    time, or ``trace_steps`` in a traced run (no window)."""
    tr, t = state["trainer"], state["traffic"]
    window = t.get("window_s")
    steps = t["trace_steps"] if window is None else max(1, math.ceil(1.1 * window / state["step_s"]))
    start = tr.start_step
    tr.cfg = dataclasses.replace(state["tcfg"], steps=start + steps)
    tr.train()  # its step_seconds start afresh
    tr.start_step = start + steps
    return {"units": steps, "phases": {}, "step_seconds": list(tr.step_seconds)}


def release(state: dict) -> None:
    import torch

    state.pop("trainer", None)
    gc.collect()
    if str(state["device"]).startswith("cuda"):
        torch.cuda.empty_cache()
    shutil.rmtree(state["work_dir"], ignore_errors=True)


def work(cfg: dict, traffic: dict) -> dict:
    """One training step's model work: the forward and the backward a LoRA
    step needs (every linear's input gradient but the patchify's and the
    caption path's, the attention's input gradients: twice the forward's
    products for self-attention, once for the text attention, whose keys
    need none), recompute not counted; and K3's shape."""
    from portbench import flops

    c, f, h, w = traffic["latent_shape"]
    s, cap = f * h * w, traffic["caption_positions"]
    dim, ff = flops.dit_dims(cfg)
    fwd = flops.dit_forward_flops(cfg, 1, s, cap)
    block_dx = 2.0 * s * dim * dim * 6 + 2.0 * s * dim * ff * 2
    attn = 2 * 4.0 * s * s * dim + 4.0 * s * cap * dim
    bwd = cfg["num_layers"] * (block_dx + attn) + 2.0 * s * dim * cfg["out_channels"]
    return {"flops": fwd + bwd, "flash_bwd": [(s, cfg["num_attention_heads"], cfg["attention_head_dim"],
                                               cfg["num_layers"])]}


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], floor_of: Dict[str, float]) -> float:
    """The worst factor's gap between the program's norm and the reference's,
    over the larger of the reference's norm and the median factor's; factors
    whose reference first gradient is under a thousandth of the median
    factor's (``floor_of``: round-off alone moves them) are left out. NaN
    where the program has no reading (no update ran)."""
    if prog is None:
        return float("nan")
    med = float(np.median(list(ref.values())))
    gmed = float(np.median(list(floor_of.values())))
    keys = [k for k in ref if floor_of[k] >= 1e-3 * gmed]
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys]
    return max(gaps) if gaps and all(np.isfinite(gaps)) else float("nan")


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    losses = [rel(a, b) for a, b in zip(prog["losses"], ref["losses"])]
    return {
        "loss_rel": max(losses) if len(losses) == len(ref["losses"]) and all(np.isfinite(losses)) else float("nan"),
        "grad1_rel": leaf_gap(prog["first_grad"], ref["first_grad"], ref["first_grad"]),
        "change3_rel": leaf_gap(prog["change"], ref["change"], ref["first_grad"]),
    }


def reference(state: dict, lowp: bool = False) -> dict:
    recipe = dict(state["traffic"]["recipe"])
    return ltx_train.train_steps(state["weights"]["dit"], state["cfg"], recipe, state["clips"],
                                 trainer_seed(state["seed"]), state["traffic"]["check_steps"], state["device"],
                                 lowp=lowp)


def picks_of(records: List[dict], k: int, seed: int) -> List[int]:
    return []


def judge(state: dict, records: List[dict], seed: int) -> Dict[str, float]:
    """Set-up's first steps, which went through the window's own call,
    against the reference's."""
    return compare(state["program"], reference(state))


def control(state: dict, records: List[dict], picks: List[int]) -> Dict[str, float]:
    return compare(reference(state, lowp=True), reference(state))
