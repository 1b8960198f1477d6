"""The port's trainer (mlx_video_tpu_torch/trainer) against the JAX package's,
on tiny_test_config in fp32 on the CPU.

Bars: the strategies' tensors equal (the same numpy inputs, the same draws);
one gradient step's loss and every LoRA gradient within 1e-4 relative L2 of
JAX ``grad_step`` (fp32 both sides; the sums run in another order); two
clipped AdamW updates within 5e-2 * lr of optax (the update's size is lr, so
this bounds a wrong clip, bias correction or decay; the arithmetic itself
agrees to fp32 rounding); schedule values to 1e-6 relative (optax computes
them in fp32). A resumed run repeats the uninterrupted run's losses.
"""

import copy
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlx_video_tpu import lora as jlora
from mlx_video_tpu.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu.models.ltx import model as jm
from mlx_video_tpu.ops import quant as jquant
from mlx_video_tpu.trainer import datasets as jdata
from mlx_video_tpu.trainer import strategies as jstrat
from mlx_video_tpu.trainer import train_step as jstep
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch.cli import train as tcli
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.io.safetensors import SafetensorsReader, save_safetensors
from mlx_video_tpu_torch.io.weights import save_dit_params
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.trainer import datasets as tdata
from mlx_video_tpu_torch.trainer import strategies as tstrat
from mlx_video_tpu_torch.trainer import train_step as tstep
from mlx_video_tpu_torch.trainer import trainer as ttrainer
from mlx_video_tpu_torch.trainer.config import TrainingConfig

CFG = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)
TCFG = tconfig.LTXModelConfig.from_dict(CFG.to_dict())
DUMMY = dict(width=128, height=64, num_frames=9, latent_dim=16, prompt_embed_dim=48, prompt_sequence_length=8)


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn gradients off process-wide when imported."""
    with torch.enable_grad():
        yield


def _batch(with_reference=False, n=1):
    ds = jdata.DummyDataset(**DUMMY, dataset_length=n, with_reference=with_reference)
    return jdata.collate_batches([ds[i] for i in range(n)])


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("strategy", ["text_to_video", "video_to_video"])
def test_prepare_matches_jax(strategy):
    batch = _batch(with_reference=strategy == "video_to_video", n=2)
    batch.conditions["prompt_attention_mask"][:, 5:] = False
    if strategy == "text_to_video":
        ref, got = jstrat.prepare_text_to_video(batch), tstrat.prepare_text_to_video(batch)
    else:
        ref, got = jstrat.prepare_video_to_video(batch), tstrat.prepare_video_to_video(batch)
    for field in tstrat.StrategyBatch._fields:
        np.testing.assert_array_equal(_np(getattr(got, field)), np.asarray(getattr(ref, field)), err_msg=field)


def test_dummy_dataset_matches_jax():
    ref, got = jdata.DummyDataset(**DUMMY), tdata.DummyDataset(**DUMMY)
    for i in (0, 3):
        for part in ("latents", "conditions"):
            a, b = getattr(ref[i], part), getattr(got[i], part)
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _write_clip(root, layout, name, shape, rng):
    """One clip's latents and conditions files; ``legacy`` stores patchified
    (S, C) latents under latent_* / condition_* names."""
    c, f, h, w = shape
    lat = rng.normal(size=shape).astype(np.float32)
    latents = {"latents": np.transpose(lat, (1, 2, 3, 0)).reshape(f * h * w, c) if layout == "legacy" else lat,
               "num_frames": np.array([f], np.int32), "height": np.array([h], np.int32),
               "width": np.array([w], np.int32), "fps": np.array([24.0], np.float32)}
    conditions = {"video_prompt_embeds": rng.normal(size=(8, 48)).astype(np.float32),
                  "prompt_attention_mask": np.arange(8) < 5}
    stems = (f"latent_{name}", f"condition_{name}") if layout == "legacy" else (f"clip_{name}",) * 2
    for sub, stem, data in zip(("latents", "conditions"), stems, (latents, conditions)):
        (root / sub).mkdir(parents=True, exist_ok=True)
        if layout == "npz":
            np.savez(root / sub / f"{stem}.npz", **data)
        else:
            save_safetensors(root / sub / f"{stem}.safetensors", {k: torch.from_numpy(v) for k, v in data.items()})


@pytest.mark.parametrize("layout", ["safetensors", "npz", "precomputed", "legacy"])
def test_precomputed_dataset_matches_jax(tmp_path, layout):
    """Samples, latent shapes and the bucketed, shuffled batch order of a
    mixed-shape dataset equal the JAX package's."""
    rng = np.random.default_rng(4)
    root = tmp_path / "data"
    for i, shape in enumerate([(16, 2, 2, 4)] * 3 + [(16, 1, 2, 2)] * 2):
        _write_clip(root / ".precomputed" if layout == "precomputed" else root, layout, f"{i:03d}", shape, rng)
    ref, got = jdata.PrecomputedDataset(root), tdata.PrecomputedDataset(root)
    assert len(got) == len(ref) == 5
    for i in range(5):
        assert got.latent_shape(i) == ref.latent_shape(i)
        for part in ("latents", "conditions"):
            a, b = getattr(ref[i], part), getattr(got[i], part)
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"{part}.{k}")
    assert tdata.num_batches_per_epoch(got, 2) == jdata.num_batches_per_epoch(ref, 2) == 3
    ref_batches = list(jdata.iter_batches(ref, 2, seed=3, prefetch=0, skip=1))
    got_batches = list(tdata.iter_batches(got, 2, seed=3, skip=1))
    assert len(got_batches) == len(ref_batches) == 2
    for a, b in zip(ref_batches, got_batches):
        np.testing.assert_array_equal(b.latents["latents"], a.latents["latents"])
        np.testing.assert_array_equal(b.conditions["video_prompt_embeds"], a.conditions["video_prompt_embeds"])


def _jax_draws(sb, key, p, mode, std=1.0):
    """The draws of JAX make_inputs, taken out the way it takes them."""
    k_sigma, k_noise, k_keep, _ = jax.random.split(key, 4)
    b, s, _ = sb.video_latents.shape
    return tstrat.Draws(
        sigmas=torch.from_numpy(np.array(jstrat.sample_sigmas(k_sigma, b, s, mode, std))),
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, sb.video_latents.shape, dtype=jnp.float32))),
        keep=torch.from_numpy(np.array(jax.random.uniform(k_keep, (b, 1)) < p)),
    )


@pytest.mark.parametrize("p", [0.0, 1.0])
@pytest.mark.parametrize("mode", ["uniform", "shifted_logit_normal"])
def test_make_inputs_and_loss_match_jax_on_the_same_draws(p, mode):
    batch = _batch(n=2)
    jsb, tsb = jstrat.prepare_text_to_video(batch), tstrat.prepare_text_to_video(batch)
    key = jax.random.key(7)
    ref = jstrat.make_inputs(jsb, key, p, mode)
    got = tstrat.make_inputs(tsb, _jax_draws(jsb, key, p, mode))
    np.testing.assert_allclose(got.video.latent.numpy(), np.asarray(ref.video.latent), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.video.timesteps.numpy(), np.asarray(ref.video.timesteps))
    np.testing.assert_allclose(got.video_targets.numpy(), np.asarray(ref.video_targets), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.video_loss_mask.numpy(), np.asarray(ref.video_loss_mask))
    pred = np.random.default_rng(1).normal(size=ref.video_targets.shape).astype(np.float32)
    np.testing.assert_allclose(
        tstrat.compute_loss(torch.from_numpy(pred), got).item(),
        float(jstrat.compute_loss(jnp.asarray(pred), None, ref)), rtol=1e-6,
    )


def _trained_tree(quantized: bool) -> dict:
    """Seeded JAX params with adapters on the default targets and non-zero
    factors (with B = 0 the A gradients vanish)."""
    rng = np.random.default_rng(3)
    shapes = jax.eval_shape(lambda: jm.init_ltx_params(jax.random.key(0), CFG, dtype=jnp.float32))
    params = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s.shape).astype(np.float32) * 0.1), shapes)
    if quantized:
        params = jquant.quantize_dit_params(params, group_size=32, bits=4)
    params = jlora.inject_lora(params, CFG, jlora.LoRAConfig(rank=4, alpha=8.0), jax.random.key(1))

    def fill(node):
        return {k: fill(v) if isinstance(v, dict)
                else (jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.05) if k == "lora_B" else v)
                for k, v in node.items()}

    return fill(params)


def _lora_grads(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_lora_grads(v, path + (k,)))
        elif k in ("lora_A", "lora_B"):
            out[".".join(path + (k,))] = np.asarray(v)
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "q4"])
@pytest.mark.parametrize("p", [0.0, 1.0], ids=["ffc_off", "ffc_on"])
@pytest.mark.parametrize("remat", [False, True], ids=["no_checkpointing", "checkpointing"])
def test_grad_step_matches_jax(quantized, p, remat):
    tree = _trained_tree(quantized)
    jcfg = dataclasses.replace(CFG, gradient_checkpointing=remat)
    tcfg = dataclasses.replace(TCFG, gradient_checkpointing=remat)
    batch = _batch()
    jsb, tsb = jstrat.prepare_text_to_video(batch), tstrat.prepare_text_to_video(batch)
    key = jax.random.key(11)
    mode = "shifted_logit_normal"
    ref_loss, ref_grads = jstep.grad_step(tree, jsb, key, jcfg, first_frame_conditioning_p=p,
                                          timestep_sampling_mode=mode)

    model = tm.LTXModel(tcfg, device="cpu", dtype=torch.float32)
    jax_bridge.load_jax_params(model, jax.tree.map(np.asarray, tree))
    params = {n: w.requires_grad_() for n, w in model.named_parameters() if ".lora_" in n}
    loss, grads = tstep.grad_step(model, params, tsb, _jax_draws(jsb, key, p, mode), tcfg)

    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    got = _lora_grads(jax_bridge.state_dict_to_jax_tree({n: g for n, g in grads.items()}))
    ref = _lora_grads(ref_grads)
    assert sorted(got) == sorted(ref) and len(ref) == 20
    for name, r in ref.items():
        assert np.linalg.norm(got[name] - r) <= 1e-4 * np.linalg.norm(r), name


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
def test_lr_schedule_matches_optax(kind):
    ref = jstep.make_lr_schedule(kind, 3e-4, 7)
    got = tstep.make_lr_schedule(kind, 3e-4, 7)
    for count in range(10):
        want = float(ref(count)) if callable(ref) else ref
        have = got(count) if callable(got) else got
        np.testing.assert_allclose(have, want, rtol=1e-6, atol=1e-12)


def test_two_clipped_adamw_updates_match_optax():
    rng = np.random.default_rng(5)
    lr = 1e-2
    params = {"lin": {"lora_A": rng.normal(size=(4, 8)).astype(np.float32),
                      "lora_B": rng.normal(size=(6, 4)).astype(np.float32),
                      "weight": rng.normal(size=(8, 6)).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: (rng.normal(size=x.shape) * 3).astype(np.float32), params) for _ in range(2)]
    mask = jax.tree_util.tree_map_with_path(lambda path, _: path[-1].key != "weight", params)
    tx = jstep.make_optimizer(jstep.make_lr_schedule("cosine", lr, 4), weight_decay=0.1, max_grad_norm=1.0,
                              trainable_mask=mask)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)

    opt = tstep.make_optimizer(tstep.make_lr_schedule("cosine", lr, 4), weight_decay=0.1, max_grad_norm=1.0)
    tp = {k: torch.from_numpy(params["lin"][k].copy()) for k in ("lora_A", "lora_B")}
    tstate = opt.init(tp)
    for g in grads:
        assert np.sqrt(sum((x ** 2).sum() for k, x in g["lin"].items() if k != "weight")) > 1.0  # clips
        tstep.apply_updates(tp, tstate, {k: torch.from_numpy(g["lin"][k]) for k in tp}, opt)
    assert tstate.count == 2
    for k, t in tp.items():
        assert np.abs(t.numpy() - np.asarray(jp["lin"][k])).max() <= 5e-2 * lr, k
    np.testing.assert_array_equal(np.asarray(jp["lin"]["weight"]), params["lin"]["weight"])  # frozen


def _write_dataset(root, n=3, seed=0):
    """A PrecomputedDataset on disk: latents (16, 2, 2, 4) and 8 caption
    tokens of 48 channels a clip."""
    rng = np.random.default_rng(seed)
    for sub in ("latents", "conditions"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        save_safetensors(root / "latents" / f"clip_{i}.safetensors", {
            "latents": torch.from_numpy(rng.normal(size=(16, 2, 2, 4)).astype(np.float32)),
            "num_frames": torch.tensor([2], dtype=torch.int32),
            "height": torch.tensor([2], dtype=torch.int32),
            "width": torch.tensor([4], dtype=torch.int32),
            "fps": torch.tensor([24.0]),
        })
        mask = np.ones(8, dtype=bool)
        mask[6:] = False
        save_safetensors(root / "conditions" / f"clip_{i}.safetensors", {
            "video_prompt_embeds": torch.from_numpy(rng.normal(size=(8, 48)).astype(np.float32)),
            "prompt_attention_mask": torch.from_numpy(mask),
        })


def _tiny_model():
    return tm.init_ltx_params(TCFG, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)


def _train_cfg(out_dir, **kw):
    base = dict(training_mode="lora", steps=4, save_every=2, lr=1e-3, lora_rank=4, output_dir=str(out_dir),
                data_root=str(out_dir.parent / "data"), scheduler_type="cosine", enable_gradient_checkpointing=True,
                timestep_sampling_mode="shifted_logit_normal", first_frame_conditioning_p=0.5,
                handle_preemption=False, mixed_precision_mode="fp32")
    return TrainingConfig(**{**base, **kw})


def test_resume_repeats_the_uninterrupted_losses(tmp_path):
    _write_dataset(tmp_path / "data")
    full = ttrainer.Trainer(_train_cfg(tmp_path / "a"),
                            model_config=TCFG, params=_tiny_model())
    full.train()
    losses = list(full.loss_history)
    assert len(losses) == 4 and np.isfinite(losses).all()
    names = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert names == ["lora_step_2.safetensors", "lora_step_4.safetensors",
                     "state_step_2.safetensors", "state_step_4.safetensors"]

    (tmp_path / "b").mkdir()
    shutil.copy(tmp_path / "a" / "state_step_2.safetensors", tmp_path / "b")
    resumed = ttrainer.Trainer(_train_cfg(tmp_path / "b", resume=True),
                               model_config=TCFG, params=_tiny_model())
    assert resumed.start_step == 2
    resumed.train()
    np.testing.assert_allclose(list(resumed.loss_history), losses[2:], rtol=1e-6)
    with SafetensorsReader(tmp_path / "a" / "lora_step_4.safetensors") as a, \
            SafetensorsReader(tmp_path / "b" / "lora_step_4.safetensors") as b:
        for k in a.keys():
            torch.testing.assert_close(b.get(k), a.get(k), rtol=1e-5, atol=1e-7)


def test_grad_accumulation_and_refusals(tmp_path):
    _write_dataset(tmp_path / "data")
    t = ttrainer.Trainer(_train_cfg(tmp_path / "o", steps=3, save_every=0, grad_accum_steps=2),
                         model_config=TCFG, params=_tiny_model())
    t.train()
    assert t.opt_state.count == 2  # one full window, then the final partial one
    with pytest.raises(NotImplementedError, match="mesh_shape"):
        ttrainer.Trainer(_train_cfg(tmp_path / "o", mesh_shape=[1, 1, 8]), model_config=TCFG, params=_tiny_model())
    model = _tiny_model()
    from mlx_video_tpu_torch.ops.quant import quantize_dit_params

    quantize_dit_params(model, group_size=32, bits=4)
    with pytest.raises(ValueError, match="LoRA training only"):
        ttrainer.Trainer(_train_cfg(tmp_path / "o", training_mode="full"), model_config=TCFG, params=model)


def test_trainer_refuses_tf32(tmp_path):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(ValueError, match="TF32 is on"):
            ttrainer.Trainer(_train_cfg(tmp_path / "o"), model_config=TCFG, params=_tiny_model())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_bf16_lora_gap_is_the_timestep_rounding():
    """One LoRA step on a 2-layer DiT (4 x 128 heads, 320 tokens, drawn
    sigma): bf16 against fp32 on the CPU. The bf16 model rounds sigma, then
    1000 * sigma, to bf16 (as the JAX package does): against fp32 on the
    exact timesteps the LoRA gradients move by tens of percent, against fp32
    on the rounded timesteps by ~1.5e-2, bf16's own rounding."""
    from mlx_video_tpu_torch.lora import LoRAConfig, inject_lora

    cfg = tconfig.LTXModelConfig(
        model_type=tconfig.LTXModelType.VideoOnly, rope_type=tconfig.LTXRopeType.SPLIT,
        double_precision_rope=True, num_attention_heads=4, attention_head_dim=128, num_layers=2,
        cross_attention_dim=512, caption_channels=256, gradient_checkpointing=True,
    )
    g = torch.Generator().manual_seed(6)
    dit = tm.init_ltx_params(cfg, g, device="cpu", dtype=torch.float32)
    inject_lora(dit, cfg, LoRAConfig(rank=8, alpha=16.0), g)
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if name.endswith("lora_B"):
                p.normal_(0.0, 0.02, generator=g)
    rng = np.random.default_rng(6)
    mask = np.zeros(16, dtype=bool)
    mask[:12] = True
    batch = tdata.Batch(
        latents={"latents": rng.normal(size=(1, 128, 5, 8, 8)).astype(np.float32),
                 "num_frames": np.array([[5]]), "height": np.array([[8]]), "width": np.array([[8]])},
        conditions={"video_prompt_embeds": rng.normal(size=(1, 16, 256)).astype(np.float32),
                    "prompt_attention_mask": mask[None]},
    )
    sb = tstrat.prepare_text_to_video(batch)
    draws = tstrat.draw_inputs(sb, torch.Generator().manual_seed(7), first_frame_conditioning_p=1.0,
                               timestep_sampling_mode="shifted_logit_normal")
    assert draws.sigmas.item() * 1000 != float(draws.sigmas.bfloat16().float() * 1000)

    def step(dtype, rounded_timesteps):
        model = copy.deepcopy(dit)
        for name, p in model.named_parameters():
            if ".lora_" not in name:  # the adapters stay fp32
                p.data = p.data.to(dtype)
        params = {n: p.requires_grad_() for n, p in model.named_parameters() if ".lora_" in n}
        inputs = tstrat.make_inputs(sb, draws, dtype=dtype)
        video = inputs.video
        if rounded_timesteps:
            m = cfg.timestep_scale_multiplier
            video = video._replace(timesteps=(video.timesteps.bfloat16() * m).float() / m)
        loss = tstrat.compute_loss(tm.ltx_apply(model, cfg, video), inputs)
        return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    bf16 = step(torch.bfloat16, False)

    def worst(ref):
        return max(((bf16[k].float() - r).norm() / r.norm()).item() for k, r in ref.items())

    assert worst(step(torch.float32, True)) <= 3e-2
    assert worst(step(torch.float32, False)) >= 0.2


def test_cli_trains_on_the_cpu(tmp_path, monkeypatch, capsys):
    _write_dataset(tmp_path / "data")
    save_dit_params(tmp_path / "tiny.safetensors", _tiny_model())
    monkeypatch.setattr(ttrainer, "build_model_config", lambda cfg: TCFG)
    tcli.main(["--model-repo", str(tmp_path / "tiny.safetensors"), "--training-mode", "lora",
               "--data-root", str(tmp_path / "data"), "--steps", "2", "--save-every", "1",
               "--lora-rank", "4", "--output-dir", str(tmp_path / "out"), "--no-preemption-handler",
               "--device", "cpu"])
    assert "Training complete" in capsys.readouterr().out
    names = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert names == ["lora_step_1.safetensors", "lora_step_2.safetensors",
                     "state_step_1.safetensors", "state_step_2.safetensors"]
    with SafetensorsReader(tmp_path / "out" / "lora_step_2.safetensors") as r:
        assert len(r.keys()) == 2 * 10 * TCFG.num_layers
        assert "diffusion_model.transformer_blocks.1.ff.proj_out.lora_B.weight" in r
    with pytest.raises(SystemExit, match="not ported"):
        tcli.main(["--model-repo", str(tmp_path / "tiny.safetensors"), "--wandb-enabled", "--device", "cpu"])
