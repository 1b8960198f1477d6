"""The port's sharded trainer against the JAX package's: ``Trainer`` with
``mesh_shape`` and ``sequence_parallel`` (full finetuning, the ring, LoRA
over a W4A8-prepared 4-bit base), its checkpoints and resume, the train CLI
with ``--mesh`` under eight ranks, the gradients of the rank-local step
against one device's (the batch on ``data``, TP, FSDP, SP, an AudioVideo
DiT), the ring backward, and what stays refused.

One spawn of eight gloo processes (tests/test_torch_port_parallel.py:
run_ranks: torch and the port only) runs every mesh_shape case on JAX's
``tiny_model`` weights and JAX's draws of each step (``fold_in(key(seed),
step)``, split as JAX's ``make_inputs`` splits it); this process runs JAX's
Trainer on its virtual 8-device CPU mesh and on one device
(tests/test_trainer.py's settings), and the port's unsharded runs. The
gradient checks run on virtual ranks (parallel/collectives.py) in this
process. Bars, with their reasons:
- losses: rtol 1e-4 against JAX's sharded and single-device runs (JAX's
  own bar between the two);
- saved trainables: rtol 1e-4 and atol 1e-2 * lr against the port's
  unsharded run (two AdamW steps of about lr each from gradients that agree
  to 1e-6 of their norm; an element whose gradient is near AdamW's eps
  moves by a step its last digits decide: a few such elements a tensor
  differ by up to 4e-6);
- gradients: relative L2 1e-4 per tensor (fp32; sums over ranks run in
  another order); the ring backward: atol 1e-5 on O(1) values;
- a resume: the uninterrupted run's loss bit for bit.
Two AdamW steps from the same start move each weight by about lr whatever
the gradient's scale, so the losses alone would not see a gradient off by a
constant factor: the gradient checks do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_video_tpu.config import LTXModelType, tiny_test_config
from mlx_video_tpu.models.ltx.model import init_ltx_params
from mlx_video_tpu.ops.quant import prepare_w4a8, quantize_dit_params
from mlx_video_tpu.trainer import datasets as jdata
from mlx_video_tpu.trainer import strategies as jstrat
from mlx_video_tpu.trainer.config import TrainingConfig as JaxTrainingConfig
from mlx_video_tpu.trainer.trainer import Trainer as JaxTrainer
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.io.safetensors import SafetensorsReader
from mlx_video_tpu_torch.io.weights import save_dit_params
from mlx_video_tpu_torch.lora import LoRAConfig, inject_lora, lora_mask
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.ops.flash_attention import flash_attention_reference
from mlx_video_tpu_torch.parallel import collectives as tcol
from mlx_video_tpu_torch.parallel import sharding as tsh
from mlx_video_tpu_torch.parallel.ring_attention import ring_attention
from mlx_video_tpu_torch.trainer import datasets as tdata
from mlx_video_tpu_torch.trainer import strategies as tstrat
from mlx_video_tpu_torch.trainer import train_step as tstep
from mlx_video_tpu_torch.trainer import trainer as ttrainer
from mlx_video_tpu_torch.trainer.config import TrainingConfig
from test_torch_port_parallel import AXES, port_config, run_ranks
from test_torch_port_train import _jax_draws, _write_dataset

SEED = 5
DUMMY = dict(width=64, height=64, num_frames=9, dataset_length=8, latent_dim=16, prompt_embed_dim=48,
             prompt_sequence_length=8)
CFG_KW = dict(model_repo="", steps=2, batch_size=1, lr=1e-3, seed=SEED, dummy_width=64, dummy_height=64,
              dummy_num_frames=9, dummy_prompt_len=8, save_every=0, log_every=100, progress=False)
# case -> (training_mode, weights, extra config); every case on mesh_shape (1, 2, 4)
CASES = {"full": ("full", "dense", {}), "sp": ("full", "dense", {"sequence_parallel": True}),
         "lora_w4a8": ("lora", "w4a8", {"lora_rank": 2})}
MESH = (1, 2, 4)


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn gradients off process-wide when imported."""
    with torch.enable_grad():
        yield


def _jax_cfg(out, mode, **kw):
    return JaxTrainingConfig(**{**CFG_KW, "training_mode": mode, "output_dir": str(out), **kw})


def _port_cfg(out, mode, **kw):
    return TrainingConfig(**{**CFG_KW, "training_mode": mode, "output_dir": str(out), **kw})


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's tiny_model trees (dense and W4A8-prepared 4-bit, group 16), its
    losses for every case on one device and on MESH, and its draws of
    steps 0 and 1."""
    tmp = tmp_path_factory.mktemp("jax")
    cfg = tiny_test_config(LTXModelType.VideoOnly)
    dense = init_ltx_params(jax.random.key(0), cfg, dtype=jnp.float32)
    trees = {"dense": dense, "w4a8": prepare_w4a8(quantize_dit_params(dense, group_size=16, bits=4))}
    losses = {}
    for name, (mode, weights, kw) in CASES.items():
        for where, mesh in (("single", None), ("mesh", MESH)):
            if where == "single" and kw.get("sequence_parallel"):
                continue
            extra = dict(kw, mesh_shape=mesh) if mesh else {k: v for k, v in kw.items() if k != "sequence_parallel"}
            tr = JaxTrainer(_jax_cfg(tmp / f"{name}_{where}", mode, **extra), model_config=cfg,
                            params=jax.tree.map(jnp.copy, trees[weights]), dataset=jdata.DummyDataset(**DUMMY))
            tr.train()
            losses[(name, where)] = list(tr.loss_history)
    sb = jstrat.prepare_text_to_video(jdata.collate_batches([jdata.DummyDataset(**DUMMY)[0]]))
    draws = [_jax_draws(sb, jax.random.fold_in(jax.random.key(SEED), step), 0.1, "uniform") for step in range(2)]
    return dict(cfg=cfg, trees=jax.tree.map(np.asarray, trees), losses=losses,
                draws=[tuple(t.numpy() if t is not None else None for t in d) for d in draws])


def _with_draws(draws):
    """Patch the port trainer to take the given draws at each step."""
    ttrainer.step_generator = lambda seed, step, device: step
    ttrainer.draw_inputs = lambda sb, step, **kw: tstrat.Draws(*(None if t is None else torch.from_numpy(t)
                                                                 for t in draws[step]))


_RANKS = r'''
import dataclasses
from mlx_video_tpu_torch.cli import train as tcli
from mlx_video_tpu_torch.io.jax_bridge import load_jax_params
from mlx_video_tpu_torch.models.ltx.model import LTXModel
from mlx_video_tpu_torch.trainer import strategies as tstrat
from mlx_video_tpu_torch.trainer import trainer as ttrainer
from mlx_video_tpu_torch.trainer.config import TrainingConfig
from mlx_video_tpu_torch.trainer.datasets import DummyDataset

cfg = inputs["cfg"]
def model(weights):
    return load_jax_params(LTXModel(cfg, device="cpu", dtype=torch.float32), inputs["trees"][weights])
real = ttrainer.step_generator, ttrainer.draw_inputs
ttrainer.step_generator = lambda seed, step, device: step
ttrainer.draw_inputs = lambda sb, step, **kw: tstrat.Draws(*(None if t is None else torch.from_numpy(t)
                                                             for t in inputs["draws"][step]))
def train(out_dir, mode, weights, **kw):
    tcfg = TrainingConfig(**{**inputs["cfg_kw"], "training_mode": mode, "output_dir": out_dir,
                             "mesh_shape": inputs["mesh"], "handle_preemption": False, **kw})
    t = ttrainer.Trainer(tcfg, model_config=cfg, params=model(weights), dataset=DummyDataset(**inputs["dummy"]))
    assert t.mesh.shape == dict(zip(("data", "fsdp", "tensor"), inputs["mesh"]))
    t.train()
    return list(t.loss_history), {k: tuple(p.shape) for k, p in t.params.items()}, t.opt_state.count

out["cases"] = {}
for name, (mode, weights, kw) in inputs["cases"].items():
    out["cases"][name] = train(f"{work}/{name}", mode, weights, **kw)
# a resume under the mesh: one step and its save, then a resumed run to two
out["one"] = train(f"{work}/resume", "full", "dense", steps=1)
out["resumed"] = train(f"{work}/resume", "full", "dense", resume=True)
with __import__("pytest").raises(ValueError, match="pipeline_stages and mesh_shape are mutually exclusive"):
    train(f"{work}/never", "full", "dense", pipeline_stages=2)

# the CLI under the same eight ranks, with the port's own draws (its bf16 base)
import contextlib, io
ttrainer.step_generator, ttrainer.draw_inputs = real
ttrainer.build_model_config = lambda c: cfg
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    tcli.main(inputs["cli_args"] + ["--mesh", "1,2,4", "--sequence-parallel", "--output-dir", f"{work}/cli"])
out["cli"] = printed.getvalue()
'''


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    """Every case on eight gloo ranks, and the port's unsharded runs of the
    full and LoRA cases and of the CLI in this process."""
    tmp = tmp_path_factory.mktemp("port")
    cfg = port_config(jax_runs["cfg"])
    dense = jax_bridge.load_jax_params(tm.LTXModel(cfg, device="cpu", dtype=torch.float32),
                                       jax_runs["trees"]["dense"])
    save_dit_params(tmp / "tiny.safetensors", dense)
    _write_dataset(tmp / "data")
    cli_args = ["--model-repo", str(tmp / "tiny.safetensors"), "--training-mode", "lora", "--lora-rank", "2",
                "--data-root", str(tmp / "data"), "--steps", "2", "--save-every", "2", "--lr", "1e-3",
                "--no-preemption-handler", "--device", "cpu"]
    inputs = dict(cfg=cfg, trees=jax_runs["trees"], draws=jax_runs["draws"], mesh=MESH, dummy=DUMMY,
                  cfg_kw=CFG_KW, cases=CASES, cli_args=cli_args)
    outs = run_ranks(_RANKS, 8, tmp / "ranks", inputs, timeout=400.0)

    real = ttrainer.step_generator, ttrainer.draw_inputs
    single = {}
    try:
        _with_draws(jax_runs["draws"])
        for name in ("full", "lora_w4a8"):
            mode, weights, kw = CASES[name]
            t = ttrainer.Trainer(_port_cfg(tmp / f"single_{name}", mode, handle_preemption=False, **kw),
                                 model_config=cfg, params=jax_bridge.load_jax_params(
                                     tm.LTXModel(cfg, device="cpu", dtype=torch.float32), jax_runs["trees"][weights]),
                                 dataset=tdata.DummyDataset(**DUMMY))
            t.train()
            single[name] = list(t.loss_history)
    finally:
        ttrainer.step_generator, ttrainer.draw_inputs = real
    from mlx_video_tpu_torch.cli import train as tcli

    old = ttrainer.build_model_config
    ttrainer.build_model_config = lambda c: cfg
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            tcli.main(cli_args + ["--output-dir", str(tmp / "cli_single")])
    finally:
        ttrainer.build_model_config = old
    return dict(outs=outs, single=single, cli=printed.getvalue(), dirs=dict(ranks=tmp / "ranks", single=tmp))


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_losses_match_jax_sharded_and_single_device(jax_runs, port_runs, case):
    """Two steps on mesh_shape (1, 2, 4): every rank reports the same
    losses, within 1e-4 of JAX's run on its mesh and on one device."""
    runs = [o["cases"][case][0] for o in port_runs["outs"]]
    assert all(r == runs[0] for r in runs)
    np.testing.assert_allclose(runs[0], jax_runs["losses"][(case, "mesh")], rtol=1e-4)
    single = "full" if case == "sp" else case
    np.testing.assert_allclose(runs[0], jax_runs["losses"][(single, "single")], rtol=1e-4)
    if case in port_runs["single"]:
        np.testing.assert_allclose(runs[0], port_runs["single"][case], rtol=1e-4)
    shapes = port_runs["outs"][0]["cases"][case][1]  # each rank trains its shards
    assert shapes["blocks.0.attn1.to_q.weight" if case != "lora_w4a8" else "blocks.0.attn1.to_q.lora_B"][0] == \
        jax_runs["cfg"].inner_dim // MESH[2]
    assert port_runs["outs"][0]["cases"][case][2] == 2  # two updates


def _tensors(path):
    with SafetensorsReader(path) as r:
        return {k: r.get(k) for k in r.keys()}


def test_sharded_checkpoints_are_the_unsharded_files(port_runs):
    """The sharded runs write what an unsharded run writes: the whole
    transformer (full) and adapter (LoRA) and the whole state, by rank 0
    alone; their trainables equal the unsharded run's at rtol 1e-4."""
    ranks, single = port_runs["dirs"]["ranks"], port_runs["dirs"]["single"]
    for case, stem in (("full", "transformer"), ("lora_w4a8", "lora")):
        got, want = _tensors(ranks / case / f"{stem}_step_2.safetensors"), \
            _tensors(single / f"single_{case}" / f"{stem}_step_2.safetensors")
        assert sorted(got) == sorted(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5, msg=k)
        got, want = _tensors(ranks / case / "state_step_2.safetensors"), \
            _tensors(single / f"single_{case}" / "state_step_2.safetensors")
        assert sorted(got) == sorted(want)
        for k in want:
            if k.startswith("params."):
                torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5, msg=k)



def test_a_save_holds_no_whole_tensor_on_a_rank_that_does_not_write(monkeypatch, tmp_path):
    """save_train_checkpoint over four virtual ranks: each tensor is
    gathered whole alone; a rank that does not write holds none of them
    after its gather, and the writer keeps them on the host and writes the
    whole model's file."""
    import gc
    import weakref

    from mlx_video_tpu_torch.trainer import checkpoints as ckpt

    cfg = port_config(tiny_test_config(LTXModelType.VideoOnly))
    whole_model = _seeded_model(cfg, False)
    names = [n for n, _ in whole_model.named_parameters()]
    gathered = {r: [] for r in range(4)}
    real = ckpt.unshard

    def recorded(t, spec, mesh):
        out = real(t, spec, mesh)
        rank = mesh.group("fsdp").rank * 2 + mesh.group("tensor").rank
        if rank:
            assert all(ref() is None for ref in gathered[rank]), "a whole tensor outlived its gather"
        gathered[rank].append(weakref.ref(out))
        return out

    monkeypatch.setattr(ckpt, "unshard", recorded)

    def rank(mg):
        sharded = tsh.shard_params(_seeded_model(cfg, False), mg)
        params = dict(sharded.named_parameters())
        state = tstep.AdamWState(count=1, mu={n: p.detach() + 1 for n, p in params.items()},
                                 nu={n: p.detach() + 2 for n, p in params.items()})
        primary = mg.group("fsdp").rank == 0 and mg.group("tensor").rank == 0
        kept = ckpt.save_train_checkpoint(tmp_path / "state.safetensors", params, state, 3,
                                          (sharded.shard_specs, mg), write=primary)
        del params, state, sharded
        gc.collect()
        return kept

    outs = tcol.run_virtual(tcol.virtual_meshes((1, 2, 2), AXES, "cpu"), rank)
    gc.collect()
    for r in (1, 2, 3):
        assert outs[r] == {}
        assert len(gathered[r]) == 3 * len(names) and all(ref() is None for ref in gathered[r])
    assert sorted(outs[0]) == sorted(names) and all(t.device.type == "cpu" for t in outs[0].values())
    saved = _tensors(tmp_path / "state.safetensors")
    for n, p in whole_model.named_parameters():
        for key, want in ((f"params.{n}", p), (f"opt.mu.{n}", p + 1), (f"opt.nu.{n}", p + 2)):
            torch.testing.assert_close(saved[key], want.detach(), rtol=0, atol=0, msg=key)


def _losses(printed: str):
    return [float(line.split("loss=")[1]) for line in printed.splitlines() if line.startswith("step ")]


def test_train_cli_under_eight_ranks(port_runs):
    """``train --mesh 1,2,4 --sequence-parallel`` on the eight gloo ranks
    (the launcher's group already joined, as torchrun's would be): rank 0
    alone prints and writes the unsharded CLI's files; its bf16 losses
    within 1e-2 of the unsharded CLI's (the bf16 base sums in another
    order)."""
    ranks, single = port_runs["dirs"]["ranks"], port_runs["dirs"]["single"]
    outs = port_runs["outs"]
    assert "Training complete" in outs[0]["cli"] and not any(o["cli"] for o in outs[1:])
    want = _losses(port_runs["cli"])
    assert len(want) == 2
    np.testing.assert_allclose(_losses(outs[0]["cli"]), want, rtol=1e-2)
    for name in ("lora_step_2.safetensors", "state_step_2.safetensors"):
        got, ref = _tensors(ranks / "cli" / name), _tensors(single / "cli_single" / name)
        assert sorted(got) == sorted(ref) and all(got[k].shape == ref[k].shape for k in ref)


def test_a_resume_under_the_mesh_repeats_the_losses_bit_for_bit(port_runs):
    for o in port_runs["outs"]:
        full, one, resumed = o["cases"]["full"][0], o["one"][0], o["resumed"][0]
        assert one == full[:1] and resumed == full[1:]


# ---------------------------------------------------------------------------
# Gradients of the rank-local step on virtual ranks
# ---------------------------------------------------------------------------


def _seeded_model(cfg, lora: bool):
    g = torch.Generator().manual_seed(0)
    m = tm.LTXModel(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=g))
    if lora:
        inject_lora(m, cfg, LoRAConfig(rank=2, alpha=4.0), torch.Generator().manual_seed(1))
        with torch.no_grad():
            for n, p in m.named_parameters():
                if n.endswith("lora_B"):  # zero at injection: give B values so A has a gradient
                    p.copy_(0.05 * torch.randn(p.shape, generator=g))
    trainable = lora_mask(m) if lora else {n: True for n, _ in m.named_parameters()}
    for n, p in m.named_parameters():
        p.requires_grad_(trainable[n])
    return m


def _grads(model, sb, draws, cfg, sp=None):
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    return tstep.grad_step(model, params, sb, draws, cfg, sp=sp)


GRAD_CASES = [("video", False, (2, 2, 2), False), ("video", True, (2, 2, 2), False), ("video", False, (1, 2, 4), True),
              ("video", True, (2, 1, 2), True), ("av", True, (1, 2, 2), True), ("av", False, (2, 2, 1), False)]


@pytest.mark.parametrize("kind,lora,mesh,sp", GRAD_CASES,
                         ids=[f"{k}-{'lora' if lo else 'full'}-{'x'.join(map(str, m))}{'-sp' if s else ''}"
                              for k, lo, m, s in GRAD_CASES])
def test_sharded_gradients_are_the_whole_models(kind, lora, mesh, sp):
    """grad_step on each rank's shards (the batch of 2 on data, FSDP, TP,
    the ring), gathered whole, against one device's gradients of the same
    step; the clip's global norm counts every shard once."""
    model_type = LTXModelType.AudioVideo if kind == "av" else LTXModelType.VideoOnly
    cfg = dataclasses.replace(port_config(tiny_test_config(model_type)), gradient_checkpointing=True)
    audio = dict(with_audio=True, audio_channels=2, audio_bins=4, audio_frames=5) if kind == "av" else {}
    ds = tdata.DummyDataset(**{**DUMMY, "dataset_length": 2}, **audio)
    sb = tstrat.prepare_text_to_video(tdata.collate_batches([ds[0], ds[1]]), with_audio=kind == "av")
    draws = tstrat.draw_inputs(sb, torch.Generator().manual_seed(3))
    loss, want = _grads(_seeded_model(cfg, lora), sb, draws, cfg)

    def rank(mg):
        sharded = tsh.shard_params(_seeded_model(cfg, lora), mg)
        for n, p in sharded.named_parameters():
            p.requires_grad_(n in want)
        got_loss, grads = _grads(sharded, sb, draws, cfg, sp=(mg, "fsdp") if sp else None)
        whole = {n: tsh.unshard(g, tsh.spec_of(sharded.shard_specs, n), mg) for n, g in grads.items()}
        return float(got_loss), whole, float(tstep.global_norm_sq(grads, sharded.shard_specs, mg))

    outs = tcol.run_virtual(tcol.virtual_meshes(mesh, AXES, "cpu"), rank)
    norm_sq = float(sum(torch.sum(g.float() ** 2) for g in want.values()))
    for got_loss, got, got_norm_sq in outs:
        np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
        assert sorted(got) == sorted(want)
        for n in want:
            err = float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-12))
            assert err <= 1e-4, (n, err)
        np.testing.assert_allclose(got_norm_sq, norm_sq, rtol=1e-5)


def test_dropping_the_column_parallel_gradient_sum_misses_the_bar(monkeypatch):
    """The control: with copy_to's backward sum dropped (each TP rank keeps
    its share of dx), the gradients upstream of the column-parallel linears
    miss the bar."""
    cfg = dataclasses.replace(port_config(tiny_test_config(LTXModelType.VideoOnly)), gradient_checkpointing=True)
    ds = tdata.DummyDataset(**DUMMY)
    sb = tstrat.prepare_text_to_video(tdata.collate_batches([ds[0]]))
    draws = tstrat.draw_inputs(sb, torch.Generator().manual_seed(3))
    _, want = _grads(_seeded_model(cfg, False), sb, draws, cfg)
    monkeypatch.setattr(tcol._CopyTo, "backward", staticmethod(lambda ctx, dy: (dy, None)))

    def rank(mg):
        sharded = tsh.shard_params(_seeded_model(cfg, False), mg)
        _, grads = _grads(sharded, sb, draws, cfg)
        return {n: tsh.unshard(g, tsh.spec_of(sharded.shard_specs, n), mg) for n, g in grads.items()}

    got = tcol.run_virtual(tcol.virtual_meshes((1, 1, 2), AXES, "cpu"), rank)[0]
    worst = max(float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-12)) for n in want)
    assert worst > 1e-2


@pytest.mark.parametrize("n", [2, 4])
def test_ring_backward_matches_autograd_through_the_whole_attention(n):
    rng = np.random.default_rng(n)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 16, 2, 8)).astype(np.float32)) for _ in range(4))
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    flash_attention_reference(qq, kk, vv, 8 ** -0.5).backward(do)

    def rank(mg):
        ring, s = mg.group("fsdp"), 16 // n
        r = ring.rank
        parts = [t[:, r * s:(r + 1) * s].clone().requires_grad_() for t in (q, k, v)]
        ring_attention(*parts, ring).backward(do[:, r * s:(r + 1) * s])
        return [p.grad for p in parts]

    outs = tcol.run_virtual(tcol.virtual_meshes((1, n, 1), AXES, "cpu"), rank)
    for i, want in enumerate((qq.grad, kk.grad, vv.grad)):
        torch.testing.assert_close(torch.cat([o[i] for o in outs], dim=1), want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Refusals, the preemption guard, the CLI without a launcher
# ---------------------------------------------------------------------------


def test_what_stays_refused_and_jax_mutual_exclusions(tmp_path):
    """pipeline_stages is refused by name (GPipe training is the ROADMAP item
    left); JAX's mutual-exclusion errors come first, as in JAX; a mesh
    larger than this lone process and SP without a mesh are refused."""
    cfg = port_config(tiny_test_config(LTXModelType.VideoOnly))
    model = tm.LTXModel(cfg, device="cpu", dtype=torch.float32)
    kw = dict(model_config=cfg, params=model, dataset=tdata.DummyDataset(**DUMMY))
    with pytest.raises(NotImplementedError, match=r"pipeline_stages \(the GPipe stages of the trainer"):
        ttrainer.Trainer(_port_cfg(tmp_path, "full", pipeline_stages=2), **kw)
    for extra, msg in ((dict(mesh_shape=[1, 2, 4]), "pipeline_stages and mesh_shape are mutually exclusive"),
                       (dict(sequence_parallel=True), "pipeline_stages and sequence_parallel are mutually exclusive")):
        with pytest.raises(ValueError, match=msg):
            ttrainer.Trainer(_port_cfg(tmp_path, "full", pipeline_stages=2, **extra), **kw)
    with pytest.raises(NotImplementedError, match=r"mesh_shape \[1, 2, 4\] spans 8 processes.*torchrun"):
        ttrainer.Trainer(_port_cfg(tmp_path, "full", mesh_shape=[1, 2, 4]), **kw)
    with pytest.raises(ValueError, match="sequence_parallel needs mesh_shape"):
        ttrainer.Trainer(_port_cfg(tmp_path, "full", sequence_parallel=True), **kw)
    from mlx_video_tpu_torch.cli import train as tcli

    with pytest.raises(SystemExit, match="--sequence-parallel .* needs --mesh"):
        tcli.main(["--sequence-parallel", "--device", "cpu"])


def test_sigterm_stops_at_a_step_and_the_resume_repeats_the_rest(tmp_path):
    """The trainer's guard is parallel/distributed.py:PreemptionGuard: a
    SIGTERM during step 1 saves step 2 and leaves PREEMPTED; the resumed
    run's losses are the uninterrupted run's."""
    cfg = port_config(tiny_test_config(LTXModelType.VideoOnly))

    def trainer(out, **kw):
        model = tm.init_ltx_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
        return ttrainer.Trainer(_port_cfg(out, "lora", steps=4, lora_rank=2, **kw), model_config=cfg, params=model,
                                dataset=tdata.DummyDataset(**DUMMY))

    whole = trainer(tmp_path / "a", handle_preemption=False)
    whole.train()
    stopped = trainer(tmp_path / "b", validation_interval=1)
    stopped.validation_fn = lambda model, step: step == 1 and os.kill(os.getpid(), signal.SIGTERM)
    stopped.train()
    assert (tmp_path / "b" / "PREEMPTED").read_text() == "2"
    assert list(stopped.loss_history) == list(whole.loss_history)[:2]
    resumed = trainer(tmp_path / "b", resume=True)
    assert resumed.start_step == 2
    resumed.train()
    assert list(resumed.loss_history) == list(whole.loss_history)[2:]
