"""Audio-video training and validation in the port (mlx_video_tpu_torch/
trainer) against the JAX package, on a 2-layer AudioVideo DiT in fp32 on the
CPU.

Bars, each with its reason:
- the strategies with audio on the same draws: model inputs atol 1e-6 and
  the loss rtol 1e-6 (the same fp32 arithmetic);
- one AV LoRA gradient step (dense and over a 4-bit base, with and without
  gradient checkpointing): loss rtol 1e-4 and every LoRA gradient within
  1e-4 relative L2 of JAX ``grad_step`` (``test_grad_step_matches_jax``'s
  bars: fp32 sums in another order);
- draws: a video-only step draws what it drew before audio existed, and an
  AV step draws the same plus the audio noise last; an AV run resumes bit
  for bit;
- ValidationSampler against JAX's on JAX's draws: per-frame latent PSNR >=
  35 dB, the repo's pipeline gate; a run with validation gives the same
  losses, bit for bit, as one without;
- the training CLI trains --with-audio on the CPU; W&B, hub push and the
  mesh options still exit by name.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_conditioned import _bundles, _JaxDraws, parts  # noqa: F401
from test_torch_port_dev import DEC_KW, psnr

from mlx_video_tpu import lora as jlora
from mlx_video_tpu.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu.models.ltx import model as jm
from mlx_video_tpu.ops import quant as jquant
from mlx_video_tpu.pipelines import generate as jgen
from mlx_video_tpu.trainer import datasets as jdata
from mlx_video_tpu.trainer import strategies as jstrat
from mlx_video_tpu.trainer import train_step as jstep
from mlx_video_tpu.trainer import validation_sampler as jval
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch.cli import train as tcli
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.io.safetensors import SafetensorsReader, save_safetensors
from mlx_video_tpu_torch.io.weights import save_dit_params
from mlx_video_tpu_torch.lora import LoRAConfig, inject_lora
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.models.ltx.video_vae import decoder as tdec
from mlx_video_tpu_torch.pipelines import generate as tgen
from mlx_video_tpu_torch.trainer import strategies as tstrat
from mlx_video_tpu_torch.trainer import train_step as tstep
from mlx_video_tpu_torch.trainer import trainer as ttrainer
from mlx_video_tpu_torch.trainer.config import TrainingConfig
from mlx_video_tpu_torch.trainer.validation_sampler import ValidationSampler

CFG = tiny_test_config(LTXModelType.AudioVideo, rope_type=LTXRopeType.SPLIT)
TCFG = tconfig.LTXModelConfig.from_dict(CFG.to_dict())
# the 28 linears of a block (10 video, 18 audio and cross-modal): the JAX
# defaults also name whole attentions ("audio_attn1", ...), which puts
# adapters on their q_norm / k_norm weights too (ROADMAP.md §3)
TARGETS = ("to_q", "to_k", "to_v", "to_out", "ff.proj_in", "ff.proj_out")
# audio latents (2 channels x 4 bins = the tiny config's 8 audio channels) of 5 frames
DUMMY = dict(width=128, height=64, num_frames=9, latent_dim=16, prompt_embed_dim=48, prompt_sequence_length=8,
             with_audio=True, audio_channels=2, audio_bins=4, audio_frames=5)


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn gradients off process-wide when imported."""
    with torch.enable_grad():
        yield


def _batch(n=1):
    ds = jdata.DummyDataset(**DUMMY, dataset_length=n)
    batch = jdata.collate_batches([ds[i] for i in range(n)])
    batch.conditions["prompt_attention_mask"][:, 6:] = False
    return batch


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jax_draws(sb, key, p, mode):
    """The draws of JAX make_inputs, taken out the way it takes them (its
    fourth key is the audio noise)."""
    k_sigma, k_noise, k_keep, k_anoise = jax.random.split(key, 4)
    b, s, _ = sb.video_latents.shape
    return tstrat.Draws(
        sigmas=torch.from_numpy(np.array(jstrat.sample_sigmas(k_sigma, b, s, mode))),
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, sb.video_latents.shape, dtype=jnp.float32))),
        keep=torch.from_numpy(np.array(jax.random.uniform(k_keep, (b, 1)) < p)),
        audio_noise=torch.from_numpy(np.array(jax.random.normal(k_anoise, sb.audio_latents.shape,
                                                                dtype=jnp.float32))),
    )


def test_prepare_with_audio_matches_jax():
    batch = _batch(n=2)
    ref = jstrat.prepare_text_to_video(batch, with_audio=True)
    got = tstrat.prepare_text_to_video(batch, with_audio=True)
    for field in tstrat.StrategyBatch._fields:
        np.testing.assert_array_equal(_np(getattr(got, field)), np.asarray(getattr(ref, field)), err_msg=field)
    assert got.audio_latents.shape == (2, 5, 8) and got.audio_positions.shape == (2, 1, 5, 2)
    del batch.conditions["audio_prompt_embeds"]  # the video's context stands in
    got = tstrat.prepare_text_to_video(batch, with_audio=True)
    np.testing.assert_array_equal(_np(got.audio_context), np.asarray(jstrat.prepare_text_to_video(
        batch, with_audio=True).audio_context))
    assert tstrat.prepare_text_to_video(batch).audio_latents is None  # without with_audio


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_make_inputs_and_loss_with_audio_match_jax(p):
    batch = _batch(n=2)
    jsb, tsb = jstrat.prepare_text_to_video(batch, True), tstrat.prepare_text_to_video(batch, True)
    key = jax.random.key(7)
    mode = "shifted_logit_normal"
    ref = jstrat.make_inputs(jsb, key, p, mode)
    got = tstrat.make_inputs(tsb, _jax_draws(jsb, key, p, mode))
    for name in ("video", "audio"):
        g, r = getattr(got, name), getattr(ref, name)
        np.testing.assert_allclose(g.latent.numpy(), np.asarray(r.latent), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(g.timesteps.numpy(), np.asarray(r.timesteps))
        np.testing.assert_array_equal(g.context.numpy(), np.asarray(r.context))
        np.testing.assert_array_equal(g.positions.numpy(), np.asarray(r.positions))
        np.testing.assert_array_equal(g.context_mask.numpy(), np.asarray(r.context_mask))
    for name in ("video_targets", "audio_targets"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-6, rtol=0)
    for name in ("video_loss_mask", "audio_loss_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    rng = np.random.default_rng(1)
    vp = rng.normal(size=ref.video_targets.shape).astype(np.float32)
    ap = rng.normal(size=ref.audio_targets.shape).astype(np.float32)
    np.testing.assert_allclose(
        tstrat.compute_loss(torch.from_numpy(vp), got, torch.from_numpy(ap)).item(),
        float(jstrat.compute_loss(jnp.asarray(vp), jnp.asarray(ap), ref)), rtol=1e-6,
    )


def test_video_only_draws_are_unchanged_and_audio_draws_last():
    """A video-only step draws sigmas, keep, noise, as before audio; an AV
    step on the same generator seed draws the same, then the audio noise."""
    batch = _batch()
    video_only, av = tstrat.prepare_text_to_video(batch), tstrat.prepare_text_to_video(batch, True)
    g = torch.Generator().manual_seed(5)
    b, s, _ = video_only.video_latents.shape
    sigmas = tstrat.sample_sigmas(g, b, s, "uniform")
    keep = torch.rand((b, 1), generator=g) < 0.5
    noise = torch.randn(video_only.video_latents.shape, generator=g)
    d = tstrat.draw_inputs(video_only, torch.Generator().manual_seed(5), 0.5)
    assert d.audio_noise is None
    assert torch.equal(d.sigmas, sigmas) and torch.equal(d.keep, keep) and torch.equal(d.noise, noise)
    d_av = tstrat.draw_inputs(av, torch.Generator().manual_seed(5), 0.5)
    assert torch.equal(d_av.sigmas, sigmas) and torch.equal(d_av.keep, keep) and torch.equal(d_av.noise, noise)
    assert torch.equal(d_av.audio_noise, torch.randn(av.audio_latents.shape, generator=g))


def _trained_tree(quantized: bool) -> dict:
    """Seeded JAX AV params with adapters on the default targets (video,
    audio and cross-modal linears) and non-zero B factors."""
    rng = np.random.default_rng(3)
    shapes = jax.eval_shape(lambda: jm.init_ltx_params(jax.random.key(0), CFG, dtype=jnp.float32))
    params = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s.shape).astype(np.float32) * 0.1), shapes)
    if quantized:
        params = jquant.quantize_dit_params(params, group_size=32, bits=4)
    params = jlora.inject_lora(params, CFG, jlora.LoRAConfig(rank=4, alpha=8.0, target_modules=TARGETS),
                               jax.random.key(1))

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
@pytest.mark.parametrize("remat", [False, True], ids=["no_checkpointing", "checkpointing"])
def test_av_grad_step_matches_jax(quantized, remat):
    tree = _trained_tree(quantized)
    jcfg = dataclasses.replace(CFG, gradient_checkpointing=remat)
    tcfg = dataclasses.replace(TCFG, gradient_checkpointing=remat)
    batch = _batch()
    jsb, tsb = jstrat.prepare_text_to_video(batch, True), tstrat.prepare_text_to_video(batch, True)
    key = jax.random.key(11)
    mode, p = "shifted_logit_normal", 0.5
    ref_loss, ref_grads = jstep.grad_step(tree, jsb, key, jcfg, first_frame_conditioning_p=p,
                                          timestep_sampling_mode=mode)

    model = tm.LTXModel(tcfg, device="cpu", dtype=torch.float32)
    jax_bridge.load_jax_params(model, jax.tree.map(np.asarray, tree))
    params = {n: w.requires_grad_() for n, w in model.named_parameters() if ".lora_" in n}
    loss, grads = tstep.grad_step(model, params, tsb, _jax_draws(jsb, key, p, mode), tcfg)

    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    got = _lora_grads(jax_bridge.state_dict_to_jax_tree(dict(grads)))
    ref = _lora_grads(ref_grads)
    assert sorted(got) == sorted(ref) and len(ref) == 2 * 28  # 28 linears a block: 10 video, 18 audio and cross
    assert any(name.startswith("blocks.audio_attn1") for name in ref)
    for name, r in ref.items():
        assert np.linalg.norm(got[name] - r) <= 1e-4 * np.linalg.norm(r), name


def test_default_targets_adapt_the_linears_only():
    """The port's default targets on an AV model adapt the 28 linears of a
    block. JAX's also give the q_norm / k_norm weights of the audio and
    cross-modal attentions adapters (a reference defect, ROADMAP.md §3),
    with a scalar lora_scale its block scan cannot take."""
    model = _tiny_model()
    inject_lora(model, TCFG, LoRAConfig(rank=4, alpha=8.0), torch.Generator().manual_seed(1))
    got = {n.rsplit(".", 1)[0] for n, _ in model.named_parameters() if n.endswith("lora_A")}
    assert len(got) == 28 * TCFG.num_layers and not any("norm" in n for n in got)
    shapes = jax.eval_shape(lambda: jm.init_ltx_params(jax.random.key(0), CFG, dtype=jnp.float32))
    params = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), shapes)
    ref = jlora.inject_lora(params, CFG, jlora.LoRAConfig(rank=4, alpha=8.0), jax.random.key(1))
    adapted = set(_lora_grads(ref))
    norms = {n for n in adapted if "_norm." in n}
    assert {n.split(".")[1] for n in norms} == {"audio_attn1", "audio_attn2", "audio_to_video_attn",
                                               "video_to_audio_attn"}
    assert len(adapted - norms) == 2 * 28  # the linears, stacked over the blocks
    assert ref["blocks"]["audio_attn1"]["q_norm"]["lora_scale"].shape == ()


def _write_av_dataset(root, n=3, seed=0):
    """latents/ (16, 2, 2, 4), conditions/ (8 caption tokens of 48, video
    and audio) and audio_latents/ (2, 5, 4) a clip."""
    rng = np.random.default_rng(seed)
    for sub in ("latents", "conditions", "audio_latents"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        save_safetensors(root / "latents" / f"clip_{i}.safetensors", {
            "latents": torch.from_numpy(rng.normal(size=(16, 2, 2, 4)).astype(np.float32)),
            "num_frames": torch.tensor([2], dtype=torch.int32), "height": torch.tensor([2], dtype=torch.int32),
            "width": torch.tensor([4], dtype=torch.int32), "fps": torch.tensor([24.0])})
        mask = np.ones(8, dtype=bool)
        mask[6:] = False
        save_safetensors(root / "conditions" / f"clip_{i}.safetensors", {
            "video_prompt_embeds": torch.from_numpy(rng.normal(size=(8, 48)).astype(np.float32)),
            "audio_prompt_embeds": torch.from_numpy(rng.normal(size=(8, 48)).astype(np.float32)),
            "prompt_attention_mask": torch.from_numpy(mask)})
        save_safetensors(root / "audio_latents" / f"clip_{i}.safetensors", {
            "latents": torch.from_numpy(rng.normal(size=(2, 5, 4)).astype(np.float32)),
            "num_time_steps": torch.tensor([5], dtype=torch.int32),
            "frequency_bins": torch.tensor([4], dtype=torch.int32)})


def _tiny_model():
    return tm.init_ltx_params(TCFG, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)


def _train_cfg(out_dir, **kw):
    base = dict(training_mode="lora", with_audio=True, steps=4, save_every=2, lr=1e-3, lora_rank=4,
                output_dir=str(out_dir), data_root=str(out_dir.parent / "data"), scheduler_type="cosine",
                enable_gradient_checkpointing=True, timestep_sampling_mode="shifted_logit_normal",
                first_frame_conditioning_p=0.5, handle_preemption=False, mixed_precision_mode="fp32")
    return TrainingConfig(**{**base, **kw})


def test_av_trainer_resumes_bit_for_bit(tmp_path):
    _write_av_dataset(tmp_path / "data")
    full = ttrainer.Trainer(_train_cfg(tmp_path / "a"), model_config=TCFG, params=_tiny_model())
    assert full.dataset.data_sources == {"latents": "latents", "conditions": "conditions",
                                         "audio_latents": "audio_latents"}
    full.train()
    losses = list(full.loss_history)
    assert len(losses) == 4 and np.isfinite(losses).all()
    audio_b = [p for n, p in full.params.items() if ".audio_attn1." in n and n.endswith("lora_B")]
    assert audio_b and all(p.norm() > 0 for p in audio_b)  # the audio adapters trained
    with SafetensorsReader(tmp_path / "a" / "lora_step_4.safetensors") as r:
        keys = set(r.keys())
    assert len(keys) == 2 * 28 * TCFG.num_layers
    assert "diffusion_model.transformer_blocks.1.video_to_audio_attn.to_out.lora_B.weight" in keys
    assert "diffusion_model.transformer_blocks.0.audio_ff.proj_in.lora_A.weight" in keys

    (tmp_path / "b").mkdir()
    shutil.copy(tmp_path / "a" / "state_step_2.safetensors", tmp_path / "b")
    resumed = ttrainer.Trainer(_train_cfg(tmp_path / "b", resume=True), model_config=TCFG, params=_tiny_model())
    assert resumed.start_step == 2
    resumed.train()
    assert list(resumed.loss_history) == losses[2:]
    with SafetensorsReader(tmp_path / "a" / "lora_step_4.safetensors") as a, \
            SafetensorsReader(tmp_path / "b" / "lora_step_4.safetensors") as b:
        for k in a.keys():
            assert torch.equal(b.get(k), a.get(k)), k


def test_build_model_config_and_the_dummy_dataset_follow_with_audio(tmp_path):
    cfg = ttrainer.build_model_config(TrainingConfig(with_audio=True))
    assert cfg.model_type == tconfig.LTXModelType.AudioVideo and cfg.num_layers == 48
    assert ttrainer.build_model_config(TrainingConfig()).model_type == tconfig.LTXModelType.VideoOnly
    t = ttrainer.Trainer(_train_cfg(tmp_path / "o", data_root=None, steps=1, save_every=0, dummy_width=64,
                                    dummy_height=64, dummy_prompt_len=8),
                         model_config=TCFG, params=_tiny_model(), dataset=None)
    assert t.dataset.with_audio and t.dataset[0].audio_latents is not None


def _sampler(parts, tmp_path, **kw):  # noqa: F811
    """A ValidationSampler on the narrow components at 128x128x9, 2 + 3
    steps, precomputed text (its bundle's transformer is the trainer's)."""
    port = tgen.ModelBundle(None, TCFG, parts["decoder"], tdec.DecoderConfig(**DEC_KW), parts["upsampler"])
    return ValidationSampler(port, output_dir=tmp_path / "val", prompts=["a"], width=128, height=128, num_frames=9,
                             steps=2, precomputed_text=tgen.TextConditioning(parts["ctx"]), seed=3, **kw)


def test_validation_sampler_matches_jax(parts, tmp_path, monkeypatch):  # noqa: F811
    """The JAX sampler (its generate_video given the tree's dtype, fp32,
    since the JAX sampler passes none) and the port's on an AV model with
    trained adapters, on JAX's draws."""
    model = _tiny_model()
    inject_lora(model, TCFG, LoRAConfig(rank=4, alpha=8.0), torch.Generator().manual_seed(2))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_B"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(len(name)))
    jtree = jax.tree.map(jnp.asarray, jax_bridge.state_dict_to_jax_layout(model.state_dict()))
    _, jax_bundle = _bundles(parts, _tiny_model())
    jax_bundle = dataclasses.replace(jax_bundle, transformer_config=CFG)
    results = {}
    jgenerate, tgenerate = jgen.generate_video, tgen.generate_video

    def jax_generate(*a, **kw):
        results["jax"] = jgenerate(*a, dtype=jnp.float32, **kw)
        return results["jax"]

    def port_generate(*a, **kw):
        results["port"] = tgenerate(*a, **kw)
        return results["port"]

    monkeypatch.setattr(jgen, "generate_video", jax_generate)
    ref_paths = jval.ValidationSampler(jax_bundle, output_dir=tmp_path / "jax", prompts=["a"], width=128, height=128,
                                       num_frames=9, steps=2, seed=3,
                                       precomputed_text=jgen.TextConditioning(jnp.asarray(parts["ctx"].numpy())),
                                       )(jtree, 4)
    keys = jax.random.split(jax.random.key(3), 8)
    draws = _JaxDraws([jax.random.normal(keys[0], (1, 16, 2, 2, 2), dtype=jnp.float32),
                       jax.random.normal(keys[1], (1, 16, 2, 4, 4), dtype=jnp.float32),
                       np.transpose(np.asarray(jax.random.normal(keys[2], (1, 2, 4, 4, 16), dtype=jnp.float32)),
                                    (0, 4, 1, 2, 3))])
    monkeypatch.setattr(tgen, "generate_video", port_generate)
    monkeypatch.setattr(torch, "randn", draws)
    paths = _sampler(parts, tmp_path)(model, 4)
    monkeypatch.undo()
    assert draws.draws == [] and [p.name for p in paths] == [p.name for p in ref_paths] == ["step_4_prompt_0.mp4"]
    assert paths[0].stat().st_size > 0 and model.training
    got, ref = results["port"].latents, results["jax"].latents
    peak = float(np.abs(ref).max())
    assert min(psnr(got[:, :, i], ref[:, :, i], peak) for i in range(ref.shape[2])) >= 35.0


def test_training_with_validation_repeats_the_losses(parts, tmp_path):  # noqa: F811
    """Validation at step 0 and after every second step: the same losses
    and adapters, bit for bit, as training without it."""
    _write_av_dataset(tmp_path / "data")
    plain = ttrainer.Trainer(_train_cfg(tmp_path / "a"), model_config=TCFG, params=_tiny_model())
    plain.train()
    sampler = _sampler(parts, tmp_path)
    calls = []

    def validate(model, step):
        calls.append(step)
        return sampler(model, step)

    validated = ttrainer.Trainer(_train_cfg(tmp_path / "b", validation_interval=2), model_config=TCFG,
                                 params=_tiny_model(), validation_fn=validate)
    validated.train()
    assert calls == [0, 2]
    assert sorted(p.name for p in (tmp_path / "val").iterdir()) == ["step_0_prompt_0.mp4", "step_2_prompt_0.mp4"]
    assert list(validated.loss_history) == list(plain.loss_history)
    for name, p in plain.params.items():
        assert torch.equal(validated.params[name], p), name
    skipped = ttrainer.Trainer(_train_cfg(tmp_path / "c", validation_interval=2, validation_skip_initial=True),
                               model_config=TCFG, params=_tiny_model(), validation_fn=lambda m, s: calls.append(s))
    skipped.train()
    assert calls == [0, 2, 2]


def test_cli_trains_with_audio_on_the_cpu(tmp_path, monkeypatch, capsys):
    _write_av_dataset(tmp_path / "data")
    save_dit_params(tmp_path / "tiny.safetensors", _tiny_model())
    monkeypatch.setattr(ttrainer, "build_model_config", lambda cfg: TCFG if cfg.with_audio else None)
    tcli.main(["--model-repo", str(tmp_path / "tiny.safetensors"), "--training-mode", "lora", "--with-audio",
               "--data-root", str(tmp_path / "data"), "--steps", "2", "--save-every", "2", "--lora-rank", "4",
               "--output-dir", str(tmp_path / "out"), "--no-preemption-handler", "--validation-prompts", "a cat",
               "--validation-interval", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Training complete" in out and "run no validation" in out
    with SafetensorsReader(tmp_path / "out" / "lora_step_2.safetensors") as r:
        assert len(r.keys()) == 2 * 28 * TCFG.num_layers
    for flags, named in ((["--wandb-enabled"], "wandb_enabled"), (["--hub-push"], "hub_push"),
                         (["--mesh", "1,1,8"], "mesh_shape"), (["--sequence-parallel"], "sequence_parallel")):
        with pytest.raises(SystemExit, match=named):
            tcli.main(["--model-repo", str(tmp_path / "tiny.safetensors"), *flags, "--device", "cpu"])


def test_model_loader_and_aux_surface(tmp_path):
    """trainer/model_loader.py: the 19B config as JAX's, and load_model on a
    snapshot with a dev DiT file; trainer/aux.py: captioning and the hub push
    refused by name."""
    from mlx_video_tpu.trainer import model_loader as jloader
    from mlx_video_tpu_torch.trainer import aux as taux
    from mlx_video_tpu_torch.trainer import model_loader as tloader

    for kind in (LTXModelType.VideoOnly, LTXModelType.AudioVideo):
        assert tloader.default_19b_config(tconfig.LTXModelType(kind.value)).to_dict() == \
            jloader.default_19b_config(kind).to_dict()
    model = _tiny_model()
    save_dit_params(tmp_path / "ltx-2-19b-dev.safetensors", model)
    got = tloader.load_model(tmp_path, TCFG, kind="dev", with_vae=False, dtype=torch.float32, device="cpu")
    assert got.transformer_config is TCFG and got.audio_decoder is None and got.vocoder is None
    want = model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in got.transformer.state_dict().items())
    assert tloader.MLXModelComponents is tloader.ModelComponents and tloader.load_gemma is tloader.load_text_encoder
    for fn, args in ((taux.caption_video, (tmp_path / "a.mp4",)), (taux.caption_image, (None,)),
                     (taux.push_to_hub, (tmp_path, "me/model"))):
        with pytest.raises(NotImplementedError, match="needs the network"):
            fn(*args)
    assert taux.set_seed(3).initial_seed() == 3
