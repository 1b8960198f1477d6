"""The port's quality/speed dials against the JAX package, on the CPU, at
narrow width (the 2-layer split-RoPE DiT, fp32): TeaCache
(``teacache_threshold``), the CFG cache (``cfg_cache_interval``) and
Pyramid Attention Broadcast (``attn_broadcast_interval``, models/ltx/model.py
``pab``), in ``denoise`` and through ``generate_video``; their refusals; the
progress callback and the step events.

Bars, each with its reason:
- dials off (interval 1, threshold 0) against no dial: bitwise, the same
  operations;
- each dial against JAX's on shared weights and inputs: rtol 2e-4 (the
  batched-video bar of tests/test_generate.py; the same fp32 forwards summed
  in another order), and >= 35 dB per latent frame through
  ``generate_video`` on JAX's draws (the pipeline gate);
- TeaCache's full steps: equal to those JAX's rule gives when replayed on
  JAX's ``_tc_signal`` over the same step inputs;
- refusals: the same ValueError text as JAX's for the same combination.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_conditioned import TCFG, _bundles, _dit, _JaxDraws, parts  # noqa: F401 (fixture)
from test_torch_port_dev import psnr

from mlx_video_tpu.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu.pipelines import denoise as jdn
from mlx_video_tpu.pipelines import generate as jgen
from mlx_video_tpu.pipelines.positions import create_position_grid
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.pipelines import denoise as tdn
from mlx_video_tpu_torch.pipelines import generate as tgen
from mlx_video_tpu_torch.utils import profiling

JCFG = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)
SIGMAS = [1.0, 0.97, 0.93, 0.85, 0.7, 0.45, 0.0]  # 6 steps: enough for a dial to cache some


@pytest.fixture(scope="module")
def setup():
    model = tm.init_ltx_params(TCFG, torch.Generator().manual_seed(9), device="cpu", dtype=torch.float32)
    params = jax.tree.map(jnp.asarray, jax_bridge.module_to_jax_tree(model))
    rng = np.random.default_rng(10)
    lat = rng.normal(size=(1, 16, 2, 4, 4)).astype(np.float32)
    ctx, neg = (rng.normal(size=(1, 8, 48)).astype(np.float32) for _ in range(2))
    return model, params, lat, create_position_grid(1, 2, 4, 4), ctx, neg


def _port(setup, cfg_on: bool, **kw):
    model, _, lat, pos, ctx, neg = setup
    extra = dict(neg_context=torch.from_numpy(neg), cfg_scale=4.0) if cfg_on else {}
    return tdn.denoise(model, TCFG, torch.from_numpy(lat), torch.from_numpy(pos), torch.from_numpy(ctx), SIGMAS,
                       **extra, **kw)[0]


def _jax(setup, cfg_on: bool, **kw):
    _, params, lat, pos, ctx, neg = setup
    extra = dict(neg_context=jnp.asarray(neg), cfg_scale=4.0) if cfg_on else {}
    return np.asarray(jdn.denoise(params, JCFG, jnp.asarray(lat), jnp.asarray(pos), jnp.asarray(ctx), SIGMAS,
                                  **extra, **kw)[0])


@pytest.mark.parametrize("cfg_on", [False, True])
def test_dials_off_equal_no_dial(setup, cfg_on):
    """Interval 1 and threshold 0 run the plain loop, bit for bit."""
    plain = _port(setup, cfg_on)
    off = _port(setup, cfg_on, attn_broadcast_interval=1, cfg_cache_interval=1, teacache_threshold=0.0)
    assert torch.equal(plain, off)


@pytest.mark.parametrize("dial,cfg_on,full", [
    (dict(attn_broadcast_interval=2), False, [0, 2, 4]),
    (dict(attn_broadcast_interval=2), True, [0, 2, 4]),
    (dict(attn_broadcast_interval=3), True, [0, 3]),
    (dict(cfg_cache_interval=2), True, [0, 2, 4]),
    (dict(cfg_cache_interval=3), True, [0, 3]),
    (dict(teacache_threshold=0.05), False, None),
    (dict(teacache_threshold=0.1), True, None),
])
def test_dial_matches_jax(setup, dial, cfg_on, full):
    """Each dial against JAX's; the steps it ran fully; and the dial does
    change the result (so it ran)."""
    steps = []
    got = _port(setup, cfg_on, **dial, full_steps=steps).numpy()
    ref = _jax(setup, cfg_on, **dial)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max())
    assert min(psnr(got[:, :, i], ref[:, :, i], float(np.abs(ref).max())) for i in range(2)) >= 35.0
    if full is not None:
        assert steps == full
    assert 0 in steps and len(steps) < len(SIGMAS) - 1
    assert not np.array_equal(got, _port(setup, cfg_on).numpy())


@pytest.mark.parametrize("threshold,cfg_on", [(0.05, False), (0.1, False), (0.1, True)])
def test_teacache_full_steps_replay_jax_rule(setup, monkeypatch, threshold, cfg_on):
    """The port's full steps equal JAX's rule replayed on JAX's _tc_signal
    over the inputs the port's loop gave its own signal."""
    _, params, *_ = setup
    inputs, signal = [], tdn._tc_signal

    def spy(model, config, v_tokens, ts):
        inputs.append((v_tokens.numpy().copy(), ts.numpy().copy()))
        return signal(model, config, v_tokens, ts)

    monkeypatch.setattr(tdn, "_tc_signal", spy)
    steps = []
    _port(setup, cfg_on, teacache_threshold=threshold, full_steps=steps)
    prev, accum, jax_full = None, np.float32(0.0), []
    for i, (tokens, ts) in enumerate(inputs):
        sig = np.asarray(jdn._tc_signal(params, JCFG, jnp.asarray(tokens), jnp.asarray(ts)))
        if prev is None:
            prev = np.zeros_like(sig)
        rel = np.float32(np.mean(np.abs(sig - prev)) / (np.mean(np.abs(prev)) + np.float32(1e-8)))
        accum_new = np.float32(accum + rel)
        full = i == 0 or accum_new >= np.float32(threshold)
        if full:
            jax_full.append(i)
        accum, prev = (np.float32(0.0) if full else accum_new), sig
    assert steps == jax_full and len(inputs) == len(SIGMAS) - 1


def _raises(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("case", [
    dict(cfg_sequential=True, cfg_cache_interval=2),
    dict(cfg_sequential=True, attn_broadcast_interval=2),
    dict(cfg_sequential=True, teacache_threshold=0.1),
    dict(teacache_threshold=0.1, audio=True),
    dict(teacache_threshold=0.1, cfg_cache_interval=2),
    dict(teacache_threshold=0.1, attn_broadcast_interval=2),
    dict(teacache_threshold=0.1, progress=True),
    dict(attn_broadcast_interval=2, audio=True),
    dict(attn_broadcast_interval=2, cfg_cache_interval=2),
    dict(attn_broadcast_interval=2, progress=True),
    dict(cfg_cache_interval=2, audio=True),
    dict(cfg_cache_interval=2, progress=True),
])
def test_dial_refusals_match_jax(setup, case):
    """Each refused combination raises JAX's ValueError, word for word
    (before any forward: the audio latents are placeholders)."""
    model, params, lat, pos, ctx, neg = setup
    kw = dict(case)
    audio, progress = kw.pop("audio", False), kw.pop("progress", False)
    jkw, tkw = dict(kw), dict(kw)
    if audio:
        jkw.update(audio_latents=jnp.zeros((1, 8, 4, 16)), audio_positions=jnp.zeros((1, 1, 4, 2)),
                   audio_context=jnp.zeros((1, 8, 32)))
        tkw.update(audio_latents=torch.zeros(1, 8, 4, 16), audio_positions=torch.zeros(1, 1, 4, 2),
                   audio_context=torch.zeros(1, 8, 32))
    if progress:
        jkw["progress_callback"] = tkw["progress_callback"] = lambda i, n: None
    ref = _raises(lambda: jdn.denoise(params, JCFG, jnp.asarray(lat), jnp.asarray(pos), jnp.asarray(ctx), SIGMAS,
                                      neg_context=jnp.asarray(neg), cfg_scale=4.0, **jkw))
    got = _raises(lambda: tdn.denoise(model, TCFG, torch.from_numpy(lat), torch.from_numpy(pos),
                                      torch.from_numpy(ctx), SIGMAS, neg_context=torch.from_numpy(neg), cfg_scale=4.0,
                                      **tkw))
    assert got == ref


def test_pab_refuses_audio_and_joint_audio_refuses_dials():
    """ltx_apply's PAB is video only, and generate_video refuses a dial with
    joint audio (both with the JAX package's text)."""
    av = tconfig.tiny_test_config(tconfig.LTXModelType.AudioVideo)
    with pytest.raises(ValueError, match="pab attention broadcast supports the video-only path"):
        tm.ltx_apply(None, av, video=None, audio=tm.Modality(torch.zeros(1), torch.zeros(1), torch.zeros(1)),
                     pab="collect")
    bundle = tgen.ModelBundle(None, av, None, None)
    for dial in (dict(attn_broadcast_interval=2), dict(cfg_cache_interval=2), dict(teacache_threshold=0.1)):
        with pytest.raises(ValueError, match="the caching dials .* support the video-only path; drop the dial"):
            tgen.generate_video(bundle, None, audio=True, audio_mode="joint", **dial)


def _generate_both(monkeypatch, tmp_path, parts, transformer, **kw):  # noqa: F811
    """generate_video in both packages on JAX's draws (a 128 x 128 x 9
    distilled run, 3 + 2 steps); (port result, JAX result)."""
    port, jax_bundle = _bundles(parts, transformer)
    kw = dict(height=128, width=128, num_frames=9, stage1_steps=3, stage2_steps=2, seed=4, tiling="none",
              video_encoder="cv2", **kw)
    ref = jgen.generate_video(jax_bundle, jgen.TextConditioning(jnp.asarray(parts["ctx"].numpy())),
                              dtype=jnp.float32, decode_latents_only=True, **kw)
    keys = jax.random.split(jax.random.key(4), 8)
    draws = _JaxDraws([jax.random.normal(keys[0], (1, 16, 2, 2, 2), dtype=jnp.float32),
                       jax.random.normal(keys[1], (1, 16, 2, 4, 4), dtype=jnp.float32)])
    monkeypatch.setattr(torch, "randn", draws)
    got = tgen.generate_video(port, tgen.TextConditioning(parts["ctx"]), dtype=torch.float32,
                              decode_latents_only=True, **kw)
    monkeypatch.undo()
    assert draws.draws == []
    return got, ref


@pytest.mark.parametrize("dial", [dict(attn_broadcast_interval=2), dict(teacache_threshold=0.05)])
def test_dials_through_generate_video_match_jax(monkeypatch, tmp_path, parts, dial):  # noqa: F811
    """Both distilled stages take the dial; the latents against JAX's."""
    got, ref = _generate_both(monkeypatch, tmp_path, parts, _dit(50), **dial)
    peak = float(np.abs(ref.latents).max())
    np.testing.assert_allclose(got.latents, ref.latents, rtol=2e-4, atol=2e-4 * peak)
    assert min(psnr(got.latents[:, :, i], ref.latents[:, :, i], peak) for i in range(2)) >= 35.0
    assert set(got.full_steps) == {"stage1_denoise", "stage2_denoise"}
    assert all(steps[0] == 0 for steps in got.full_steps.values())
    if "attn_broadcast_interval" in dial:
        assert got.full_steps == {"stage1_denoise": [0, 2], "stage2_denoise": [0]}


def test_progress_callback_and_step_events(parts):  # noqa: F811
    """progress_callback(step, total) after every video denoise step, in
    place of the events; with a sink subscribed, one denoise_step event a
    step and a phase event a phase; none without."""
    port, _ = _bundles(parts, _dit(51))
    kw = dict(height=128, width=128, num_frames=9, stage1_steps=2, stage2_steps=1, dtype=torch.float32,
              decode_latents_only=True)
    calls, events = [], []
    tgen.generate_video(port, tgen.TextConditioning(parts["ctx"]), progress_callback=lambda i, n: calls.append((i, n)),
                        **kw)
    assert calls == [(1, 2), (2, 2), (1, 1)]
    with pytest.raises(ValueError, match="per-step progress_callback is unsupported"):
        tgen.generate_video(port, tgen.TextConditioning(parts["ctx"]), progress_callback=lambda i, n: None,
                            attn_broadcast_interval=2, **kw)
    profiling.add_event_sink(events.append)
    try:
        tgen.generate_video(port, tgen.TextConditioning(parts["ctx"]), **kw)
    finally:
        profiling.remove_event_sink(events.append)
    steps = [(e["step"], e["total"]) for e in events if e["kind"] == "denoise_step"]
    assert steps == [(1, 2), (2, 2), (1, 1)]
    assert [e["phase"] for e in events if e["kind"] == "phase"] == ["stage1_denoise", "upsample", "stage2_denoise"]
    assert all(e["sigma"] == float(np.float32(e["sigma"])) for e in events if e["kind"] == "denoise_step")
    events.clear()
    tgen.generate_video(port, tgen.TextConditioning(parts["ctx"]), **kw)
    assert events == [] and not profiling.has_event_sinks()
