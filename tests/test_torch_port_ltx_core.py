"""The port's ltx_core (mlx_video_tpu_torch/ltx_core/) against the JAX
package's (ltx_core/), on the CPU: one counterpart for each ltx_core test of
tests/test_parity_packages.py, each feeding the same numpy inputs, made from
a seed, to the JAX function and to the port's.

Bars, each with its reason:
- fp32 elementwise pieces (guiders, utils, the Euler step, patchifiers,
  tools, masks, schedulers): max |d| <= 1e-6 of the largest value (the same
  fp32 arithmetic; reductions summed in another order);
- shapes, positions, token counts and argv: exact;
- class-adapter forwards: 5e-4 of the largest value, the DiT bar of
  tests/test_torch_port_dev.py and tests/test_torch_port_dit.py (convolutions
  and attention reduce in another order);
- ``GaussianNoiser``: shape, dtype, moments and repeatability only, since
  JAX's random streams cannot be reproduced in torch.

The reference defect pinned here: JAX's ``LTXModel.__call__`` passes
``perturbations`` on to ``ltx_apply``, which takes none, so JAX's
``X0Model`` raises on ``perturbations=None`` (the call every reference
denoising helper makes); the port's accepts None or an empty config and
refuses, naming STG, a config that perturbs a block.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx_core import components as jcomp
from ltx_core import tools as jtools
from ltx_core import types as jtypes
from ltx_core import utils as jutils
from ltx_core.guidance import perturbations as jpert
from mlx_video_tpu.config import LTXModelType, VideoVAEConfig as JaxVAEConfig, tiny_test_config
from mlx_video_tpu.models.ltx.audio_vae.audio_vae import AudioVAEConfig as JaxAudioVAEConfig
from mlx_video_tpu.models.ltx.audio_vae.vocoder import VocoderConfig as JaxVocoderConfig
from mlx_video_tpu.models.ltx.video_vae.decoder import DecoderConfig as JaxDecoderConfig
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.ltx_core import components as tcomp
from mlx_video_tpu_torch.ltx_core import tools as ttools
from mlx_video_tpu_torch.ltx_core import types as ttypes
from mlx_video_tpu_torch.ltx_core import utils as tutils
from mlx_video_tpu_torch.ltx_core.guidance import perturbations as tpert
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.models.ltx.audio_vae import audio_vae as taudio
from mlx_video_tpu_torch.models.ltx.audio_vae import vocoder as tvoc
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig

FWD_BAR = 5e-4
ELEM_BAR = 1e-6


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _elem(got, ref, bar: float = ELEM_BAR) -> None:
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= bar * max(float(np.abs(ref).max()), 1e-30)


def _fwd(got, ref) -> None:
    _elem(got, ref, FWD_BAR)


def _pair(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# --- guiders ---

GUIDERS = [
    ("CFGGuider", dict(scale=4.0)),
    ("CFGStarRescalingGuider", dict(scale=4.0)),
    ("STGGuider", dict(scale=2.0)),
    ("LtxAPGGuider", dict(scale=4.0, eta=1.0, norm_threshold=0.0)),
    ("LtxAPGGuider", dict(scale=4.0, eta=0.0, norm_threshold=0.0)),
    ("LtxAPGGuider", dict(scale=3.0, eta=0.5, norm_threshold=2.0)),
]


@pytest.mark.parametrize("case", GUIDERS, ids=lambda c: f"{c[0]}-{'-'.join(map(str, c[1].values()))}")
def test_guider_deltas_match_jax(case, rng):
    name, kw = case
    jc, tc = _pair(rng, (2, 3, 4, 4))
    ju, tu = _pair(rng, (2, 3, 4, 4))
    jg, tg = getattr(jcomp, name)(**kw), getattr(tcomp, name)(**kw)
    _elem(tg.delta(tc, tu), jg.delta(jc, ju))
    assert tg.enabled() == jg.enabled()


def test_cfg_star_projects_and_cfg_disables(rng):
    """CFG* with uncond == cond gives a zero delta, CFG at scale 1 is off
    (the JAX tests' own checks), the same on both sides."""
    jc, tc = _pair(rng, (2, 4, 4))
    _elem(tcomp.CFGStarRescalingGuider(4.0).delta(tc, tc), jcomp.CFGStarRescalingGuider(4.0).delta(jc, jc), 1.0)
    assert float(tcomp.CFGStarRescalingGuider(4.0).delta(tc, tc).abs().max()) <= 1e-5
    assert not tcomp.CFGGuider(1.0).enabled() and not jcomp.CFGGuider(1.0).enabled()
    assert not tcomp.STGGuider(0.0).enabled()


def test_apg_eta_zero_is_orthogonal(rng):
    jc, tc = _pair(rng, (1, 2, 3, 4))
    ju, tu = _pair(rng, (1, 2, 3, 4))
    delta = tcomp.LtxAPGGuider(scale=4.0, eta=0.0).delta(tc, tu).reshape(1, -1)
    c = tc.reshape(1, -1)
    assert abs(float(delta @ c.T)) / float(delta.norm() * c.norm()) < 1e-4
    _elem(delta, jcomp.LtxAPGGuider(scale=4.0, eta=0.0).delta(jc, ju).reshape(1, -1))


@pytest.mark.parametrize("momentum", [0.0, 0.5])
def test_legacy_stateful_apg_matches_jax(momentum, rng):
    """Three calls, so the running average carries state on both sides."""
    jg = jcomp.LegacyStatefulAPGGuider(scale=2.0, eta=0.5, norm_threshold=5.0, momentum=momentum)
    tg = tcomp.LegacyStatefulAPGGuider(scale=2.0, eta=0.5, norm_threshold=5.0, momentum=momentum)
    for _ in range(3):
        jc, tc = _pair(rng, (2, 3, 4, 4))
        ju, tu = _pair(rng, (2, 3, 4, 4))
        _elem(tg.delta(tc, tu), jg.delta(jc, ju))
    assert (tg.running_avg is None) == (momentum == 0.0)


# --- schedulers ---

@pytest.mark.parametrize("steps", [1, 8, 20])
def test_schedulers_match_jax(steps):
    latent_j, latent_t = jnp.zeros((1, 128, 5, 16, 16)), torch.zeros(1, 128, 5, 16, 16)
    _elem(tcomp.LTX2Scheduler().execute(steps, latent=latent_t), jcomp.LTX2Scheduler().execute(steps, latent=latent_j))
    _elem(tcomp.LTX2Scheduler().execute(steps), jcomp.LTX2Scheduler().execute(steps))
    t_lq, j_lq = tcomp.LinearQuadraticScheduler().execute(steps), jcomp.LinearQuadraticScheduler().execute(steps)
    _elem(t_lq, j_lq)
    assert t_lq.shape == (steps + 1,) and t_lq[0] == 1.0 and t_lq[-1] == 0.0 and np.all(np.diff(t_lq) <= 1e-6)
    if steps > 1:
        t_beta, j_beta = tcomp.BetaScheduler().execute(steps), jcomp.BetaScheduler().execute(steps)
        np.testing.assert_array_equal(t_beta, j_beta)
        assert t_beta[-1] == 0.0 and t_beta[0] > 0.9 and np.all(np.diff(t_beta) < 0)


# --- diffusion step and the velocity/denoised islands ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_euler_step_matches_jax(dtype, rng):
    x = rng.normal(size=(1, 4, 4)).astype(np.float32)
    x0 = rng.normal(size=(1, 4, 4)).astype(np.float32)
    sigmas = np.asarray([1.0, 0.5, 0.0], np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    for i in (0, 1):
        ref = jcomp.EulerDiffusionStep().execute(jnp.asarray(x, jd), jnp.asarray(x0, jd), sigmas, i)
        got = tcomp.EulerDiffusionStep().execute(torch.from_numpy(x).to(td), torch.from_numpy(x0).to(td), sigmas, i)
        assert got.dtype == td
        _elem(got, ref)
    # euler: x + v*dt with v=(x-x0)/sigma, dt=-0.5 => x0 + 0.5*(x - x0)
    got = tcomp.EulerDiffusionStep().execute(torch.from_numpy(x), torch.from_numpy(x0), sigmas, 0)
    np.testing.assert_allclose(got.numpy(), x0 + 0.5 * (x - x0), atol=1e-5)


@pytest.mark.parametrize("sigma", ["scalar", "per_token"])
def test_velocity_denoised_islands_match_jax(sigma, rng):
    x = rng.normal(size=(2, 3, 4)).astype(np.float32)
    x0 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    s = 0.7 if sigma == "scalar" else rng.uniform(0.2, 1.0, size=(2, 3)).astype(np.float32)
    jv = jutils.to_velocity(jnp.asarray(x), jnp.asarray(x0), s)
    tv = tutils.to_velocity(torch.from_numpy(x), torch.from_numpy(x0), s if sigma == "scalar" else torch.from_numpy(s))
    _elem(tv, jv)
    back = tutils.to_denoised(torch.from_numpy(x), tv, s if sigma == "scalar" else torch.from_numpy(s))
    _elem(back, jutils.to_denoised(jnp.asarray(x), jv, s))
    np.testing.assert_allclose(back.numpy(), x0, atol=1e-5)


# --- patchifiers and shapes ---

@pytest.mark.parametrize("patch", [1, 2])
def test_video_patchifier_matches_jax(patch, rng):
    shape = ttypes.VideoLatentShape(1, 8, 2, 4, 4)
    jp, tp = jcomp.VideoLatentPatchifier(patch_size=patch), tcomp.VideoLatentPatchifier(patch_size=patch)
    jl, tl = _pair(rng, shape.to_shape())
    tokens = tp.patchify(tl)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jp.patchify(jl)))
    np.testing.assert_array_equal(tp.unpatchify(tokens, shape).numpy(), tl.numpy())
    assert tp.get_token_count(shape) == jp.get_token_count(jtypes.VideoLatentShape(*shape)) == 32 // patch**2
    np.testing.assert_array_equal(tp.get_patch_grid_bounds(shape, device="cpu").numpy(),
                                  np.asarray(jp.get_patch_grid_bounds(jtypes.VideoLatentShape(*shape))))


@pytest.mark.parametrize("causal_fix", [False, True])
def test_pixel_coords_match_jax_and_engine_positions(causal_fix):
    from mlx_video_tpu_torch.pipelines.positions import create_position_grid

    shape = ttypes.VideoLatentShape(1, 128, 3, 4, 5)
    coords = tcomp.VideoLatentPatchifier(1).get_patch_grid_bounds(shape, device="cpu")
    got = tcomp.get_pixel_coords(coords, ttypes.SpatioTemporalScaleFactors.default(), causal_fix=causal_fix)
    jcoords = jcomp.VideoLatentPatchifier(1).get_patch_grid_bounds(jtypes.VideoLatentShape(*shape))
    ref = jcomp.get_pixel_coords(jcoords, jtypes.SpatioTemporalScaleFactors.default(), causal_fix=causal_fix)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if causal_fix:
        got[:, 0] /= 24.0
        np.testing.assert_allclose(got.numpy(), create_position_grid(1, 3, 4, 5, fps=24.0), atol=1e-5)


def test_latent_shape_math_matches_jax():
    for frames, fps in ((33, 24.0), (48, 24.0), (121, 25.0), (9, 24.0)):
        tpx = ttypes.VideoPixelShape(batch=1, frames=frames, height=512, width=768, fps=fps)
        jpx = jtypes.VideoPixelShape(*tpx)
        assert tuple(ttypes.VideoLatentShape.from_pixel_shape(tpx)) == tuple(jtypes.VideoLatentShape.from_pixel_shape(jpx))
        assert tuple(ttypes.AudioLatentShape.from_video_pixel_shape(tpx)) == \
            tuple(jtypes.AudioLatentShape.from_video_pixel_shape(jpx))
        lat = ttypes.VideoLatentShape.from_pixel_shape(tpx)
        assert tuple(lat.upscale()) == tuple(jtypes.VideoLatentShape(*lat).upscale())
        assert tuple(lat.mask_shape()) == tuple(jtypes.VideoLatentShape(*lat).mask_shape())
    assert ttypes.VideoLatentShape.from_pixel_shape(ttypes.VideoPixelShape(1, 33, 512, 768, 24)) == \
        ttypes.VideoLatentShape(1, 128, 5, 16, 24)
    assert ttypes.AudioLatentShape.from_video_pixel_shape(ttypes.VideoPixelShape(1, 48, 64, 64, 24.0)) == \
        ttypes.AudioLatentShape(1, 8, 50, 16)


def test_audio_patchifier_matches_jax(rng):
    shape = ttypes.AudioLatentShape(2, 8, 6, 16)
    for shift, causal in ((0, True), (3, False)):
        jp = jcomp.AudioPatchifier(1, is_causal=causal, shift=shift)
        tp = tcomp.AudioPatchifier(1, is_causal=causal, shift=shift)
        jl, tl = _pair(rng, shape.to_shape())
        tokens = tp.patchify(tl)
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(jp.patchify(jl)))
        np.testing.assert_array_equal(tp.unpatchify(tokens, shape).numpy(), tl.numpy())
        np.testing.assert_array_equal(tp.get_patch_grid_bounds(shape, device="cpu").numpy(),
                                      np.asarray(jp.get_patch_grid_bounds(jtypes.AudioLatentShape(*shape))))


# --- tools ---

def test_video_tools_match_jax(rng):
    shape = ttypes.VideoLatentShape(1, 8, 2, 4, 4)
    init = rng.normal(size=shape.to_shape()).astype(np.float32)
    tt, jt = ttools.VideoLatentTools(target_shape=shape, fps=25.0), jtools.VideoLatentTools(
        target_shape=jtypes.VideoLatentShape(*shape), fps=25.0)
    ts = tt.create_initial_state(initial_latent=torch.from_numpy(init), device="cpu")
    js = jt.create_initial_state(initial_latent=jnp.asarray(init))
    for name in ("latent", "clean_latent", "denoise_mask", "positions"):
        _elem(getattr(ts, name), getattr(js, name))
    assert ts.positions.shape == (1, 3, 32, 2)
    tpat, jpat = tt.patchify(ts), jt.patchify(js)
    for name in ("latent", "clean_latent", "denoise_mask"):
        np.testing.assert_array_equal(getattr(tpat, name).numpy(), np.asarray(getattr(jpat, name)))
    assert tpat.latent.shape == (1, 32, 8)
    np.testing.assert_array_equal(tt.unpatchify(tpat).latent.numpy(), init)
    cleared = tt.clear_conditioning(tpat)
    np.testing.assert_array_equal(cleared.denoise_mask.numpy(), np.asarray(jt.clear_conditioning(jpat).denoise_mask))
    with pytest.raises(ValueError, match="expected"):
        tt.patchify(tpat)


def test_tools_draws_and_devices():
    """A generator's draw is repeatable and fp32-then-cast, zeros without
    one; every tensor of the state is on the latent's device, and that is
    the card unless ``device`` says otherwise."""
    shape = ttypes.VideoLatentShape(1, 8, 2, 4, 4)
    tt = ttools.VideoLatentTools(target_shape=shape)
    a = tt.create_initial_state(generator=torch.Generator().manual_seed(3), dtype=torch.bfloat16, device="cpu")
    b = tt.create_initial_state(generator=torch.Generator().manual_seed(3), dtype=torch.bfloat16, device="cpu")
    want = torch.randn(shape.to_shape(), generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    assert torch.equal(a.latent, b.latent) and torch.equal(a.latent, want) and a.latent.dtype == torch.bfloat16
    assert a.positions.dtype == torch.float32
    assert float(tt.create_initial_state(device="cpu").latent.abs().max()) == 0.0
    assert all(getattr(a, n).device.type == "cpu" for n in ("latent", "clean_latent", "denoise_mask", "positions"))
    for default in (lambda: tt.create_initial_state(), lambda: tt.create_initial_state(
            initial_latent=torch.zeros(shape.to_shape())), lambda: tt.create_initial_state(
            generator=torch.Generator().manual_seed(3))):
        if torch.cuda.is_available():
            assert default().latent.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                default()


def test_audio_tools_match_jax(rng):
    shape = ttypes.AudioLatentShape(1, 8, 6, 16)
    init = rng.normal(size=shape.to_shape()).astype(np.float32)
    tt, jt = ttools.AudioLatentTools(target_shape=shape), jtools.AudioLatentTools(
        target_shape=jtypes.AudioLatentShape(*shape))
    ts, js = tt.create_initial_state(initial_latent=torch.from_numpy(init), device="cpu"), jt.create_initial_state(
        initial_latent=jnp.asarray(init))
    for name in ("latent", "clean_latent", "denoise_mask", "positions"):
        _elem(getattr(ts, name), getattr(js, name))
    tpat, jpat = tt.patchify(ts), jt.patchify(js)
    assert tpat.latent.shape == (1, 6, 128) and tpat.denoise_mask.shape == (1, 6, 1)
    np.testing.assert_array_equal(tpat.latent.numpy(), np.asarray(jpat.latent))
    np.testing.assert_array_equal(tt.unpatchify(tpat).latent.numpy(), init)


# --- perturbations ---

def _perturbation_configs(mod):
    return mod.BatchedPerturbationConfig([
        mod.PerturbationConfig([mod.Perturbation(mod.PerturbationType.SKIP_VIDEO_SELF_ATTN, [1, 2])]),
        mod.PerturbationConfig.empty(),
        mod.PerturbationConfig([mod.Perturbation(mod.PerturbationType.SKIP_A2V_CROSS_ATTN, None)]),
    ])


def test_perturbation_masks_match_jax():
    tcfg, jcfg = _perturbation_configs(tpert), _perturbation_configs(jpert)
    values = torch.zeros(3, 4, 5, dtype=torch.bfloat16)
    for kind in tpert.PerturbationType:
        jkind = jpert.PerturbationType(kind.value)
        for block in range(4):
            mask = tcfg.mask(kind, block, device="cpu")
            np.testing.assert_array_equal(mask.numpy(), np.asarray(jcfg.mask(jkind, block)))
            like = tcfg.mask_like(kind, block, values)
            assert like.shape == (3, 1, 1) and like.dtype == torch.bfloat16
            np.testing.assert_array_equal(like.float().numpy(),
                                          np.asarray(jcfg.mask_like(jkind, block, jnp.zeros((3, 4, 5))), np.float32))
            assert tcfg.any_in_batch(kind, block) == jcfg.any_in_batch(jkind, block)
            assert tcfg.all_in_batch(kind, block) == jcfg.all_in_batch(jkind, block)
    np.testing.assert_array_equal(tcfg.mask(tpert.PerturbationType.SKIP_VIDEO_SELF_ATTN, 1, device="cpu").numpy(),
                                  [0.0, 1.0, 1.0])
    assert len(tpert.BatchedPerturbationConfig.empty(2).perturbations) == 2


# --- noiser ---

def test_gaussian_noiser_draws():
    """Shape, dtype, moments and repeatability: JAX's streams cannot be
    reproduced, so the values are not compared."""
    like = torch.zeros(4, 64, 32, dtype=torch.bfloat16)
    a, b = tcomp.GaussianNoiser(seed=5), tcomp.GaussianNoiser(seed=5)
    first, second = a.noise(like), a.noise(like)
    assert first.shape == like.shape and first.dtype == torch.bfloat16
    assert torch.equal(first, b.noise(like)) and not torch.equal(first, second)
    assert torch.equal(second, b.noise(like))
    x = first.float()
    assert abs(float(x.mean())) < 0.05 and abs(float(x.std()) - 1.0) < 0.05
    assert not torch.equal(tcomp.GaussianNoiser(seed=6).noise(like), first)
    j = np.asarray(jcomp.GaussianNoiser(seed=5).noise(jnp.zeros((4, 64, 32), jnp.bfloat16)), np.float32)
    assert j.shape == tuple(x.shape) and abs(float(j.std()) - float(x.std())) < 0.05


# --- conditioning items (token domain) ---

@pytest.mark.parametrize("kind", ["latent", "keyframe"])
@pytest.mark.parametrize("frame_idx", [0, 1])
def test_conditioning_apply_to_matches_jax(kind, frame_idx, rng):
    from ltx_core import conditioning as jcond
    from mlx_video_tpu.pipelines import conditioning as jengine
    from mlx_video_tpu_torch.ltx_core import conditioning as tcond
    from mlx_video_tpu_torch.pipelines import conditioning as tengine

    shape = ttypes.VideoLatentShape(1, 8, 2, 4, 4)
    init = rng.normal(size=shape.to_shape()).astype(np.float32)
    cond = rng.normal(size=(1, 8, 1, 4, 4)).astype(np.float32)
    tt, jt = ttools.VideoLatentTools(target_shape=shape), jtools.VideoLatentTools(
        target_shape=jtypes.VideoLatentShape(*shape))
    ts = tt.patchify(tt.create_initial_state(initial_latent=torch.from_numpy(init), device="cpu"))
    js = jt.patchify(jt.create_initial_state(initial_latent=jnp.asarray(init)))
    if kind == "latent":
        ti = tcond.VideoConditionByLatentIndex(latent=torch.from_numpy(cond), frame_idx=frame_idx, strength=0.8)
        ji = jcond.VideoConditionByLatentIndex(latent=jnp.asarray(cond), frame_idx=frame_idx, strength=0.8)
        assert isinstance(ti, tengine.VideoConditionByLatentIndex) and isinstance(ji, jengine.VideoConditionByLatentIndex)
    else:
        ti = tcond.VideoConditionByKeyframeIndex(keyframes=torch.from_numpy(cond), frame_idx=frame_idx, strength=0.8)
        ji = jcond.VideoConditionByKeyframeIndex(keyframes=jnp.asarray(cond), frame_idx=frame_idx, strength=0.8)
    tout, jout = ti.apply_to(ts, tt), ji.apply_to(js, jt)
    for name in ("latent", "clean_latent", "denoise_mask", "positions"):
        _elem(getattr(tout, name), getattr(jout, name))
    assert tout.latent.shape == (1, 48, 8)
    np.testing.assert_allclose(tout.denoise_mask[:, 32:].numpy(), 0.2, atol=1e-6)
    assert tt.clear_conditioning(tout).positions.shape == (1, 3, 32, 2)


# --- class adapters ---

def _tiny_dit(model_type, seed=0, **kw):
    cfg = dataclasses.replace(tiny_test_config(model_type), **kw)
    tcfg = tconfig.LTXModelConfig.from_dict(cfg.to_dict())
    model = tm.init_ltx_params(tcfg, torch.Generator().manual_seed(seed), device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bias", "scale_shift_table")) or "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(seed + 1)))
    return cfg, tcfg, model, _jax(jax_bridge.module_to_jax_tree(model))


def _fresh(name, tmp_path):
    """A callable that builds one of ltx_core's device-taking objects with no
    device given, and the tensor whose device shows where it went."""
    from mlx_video_tpu_torch.io.safetensors import save_safetensors
    from mlx_video_tpu_torch.ltx_core.loader.sft_loader import SafetensorsModelStateDictLoader
    from mlx_video_tpu_torch.ltx_core.model.transformer import LTXModel
    from mlx_video_tpu_torch.ltx_core.model.upsampler import LatentUpsampler

    if name == "LTXModel":
        tcfg = tconfig.LTXModelConfig.from_dict(tiny_test_config(LTXModelType.VideoOnly).to_dict())
        return lambda: next(LTXModel(tcfg).params.parameters())
    if name == "LatentUpsampler":
        return lambda: next(LatentUpsampler(in_channels=16, mid_channels=32, num_blocks=1).params.parameters())
    if name == "sft_loader":
        save_safetensors(tmp_path / "x.safetensors", {"a": torch.zeros(3)})
        return lambda: SafetensorsModelStateDictLoader(tmp_path / "x.safetensors").load()["a"]
    if name == "mask":
        return lambda: tpert.BatchedPerturbationConfig([tpert.PerturbationConfig.empty()]).mask(
            tpert.PerturbationType.SKIP_VIDEO_SELF_ATTN, 0)
    return lambda: tcomp.AudioPatchifier(1).get_patch_grid_bounds(ttypes.AudioLatentShape(1, 8, 3, 16))


@pytest.mark.parametrize("name", ["LTXModel", "LatentUpsampler", "sft_loader", "mask", "grid_bounds"])
def test_no_device_means_the_card(name, tmp_path):
    """Fresh adapter weights, loaded state dicts, masks and position grids
    land on the card when no device is given, or raise naming device='cpu'
    where there is none (JAX put them on its default accelerator)."""
    build = _fresh(name, tmp_path)
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def _video_modality(cfg, rng, b=1, f=2, h=4, w=4, sigma=0.5):
    from mlx_video_tpu.pipelines.positions import create_position_grid

    lat = rng.normal(size=(b, f * h * w, cfg.in_channels)).astype(np.float32)
    ctx = rng.normal(size=(b, 8, cfg.caption_channels)).astype(np.float32)
    ts = np.full((b, f * h * w), sigma, np.float32)
    pos = create_position_grid(b, f, h, w)
    return dict(latent=lat, timesteps=ts, context=ctx, positions=pos)


def test_ltx_model_and_x0_match_jax(rng):
    from ltx_core.model.transformer import LTXModel as JLTXModel, X0Model as JX0Model
    from mlx_video_tpu.models.ltx.model import Modality as JModality
    from mlx_video_tpu_torch.ltx_core.model.transformer import LTXModel, X0Model

    cfg, tcfg, model, params = _tiny_dit(LTXModelType.VideoOnly)
    x = _video_modality(cfg, rng)
    jvideo = JModality(**{k: jnp.asarray(v) for k, v in x.items()})
    tvideo = tm.Modality(**{k: torch.from_numpy(v) for k, v in x.items()})
    wrapped = LTXModel(tcfg, model)
    assert wrapped.params is model  # in place: no second copy of the weights
    jmodel = JLTXModel(cfg, params)
    v_vel, a_vel = wrapped(video=tvideo)
    ref, _ = jax.jit(lambda v: jmodel(video=v))(jvideo)
    assert a_vel is None
    _fwd(v_vel, ref)
    x0, _ = X0Model(wrapped)(video=tvideo, perturbations=None)
    jx0, _ = jax.jit(lambda v: JX0Model(jmodel)(video=v))(jvideo)
    _fwd(x0, jx0)
    np.testing.assert_allclose(x0.numpy(), (tvideo.latent - tvideo.timesteps[..., None] * v_vel).numpy(), atol=1e-6)


def test_jax_x0model_raises_on_perturbations_none(rng):
    """The reference defect: JAX's X0Model passes ``perturbations`` on to
    ``ltx_apply``, which takes none; every reference denoising helper
    passes ``perturbations=None``. The port's X0Model takes it."""
    from ltx_core.model.transformer import LTXModel as JLTXModel, X0Model as JX0Model
    from mlx_video_tpu.models.ltx.model import Modality as JModality
    from mlx_video_tpu_torch.ltx_core.guidance.perturbations import BatchedPerturbationConfig, PerturbationConfig
    from mlx_video_tpu_torch.ltx_core.model.transformer import LTXModel, X0Model

    cfg, tcfg, model, params = _tiny_dit(LTXModelType.VideoOnly)
    x = _video_modality(cfg, rng)
    with pytest.raises(TypeError, match="perturbations"):
        JX0Model(JLTXModel(cfg, params))(video=JModality(**{k: jnp.asarray(v) for k, v in x.items()}),
                                          perturbations=None)
    x0 = X0Model(LTXModel(tcfg, model))
    video = tm.Modality(**{k: torch.from_numpy(v) for k, v in x.items()})
    plain, _ = x0(video=video, perturbations=None)
    for empty in (PerturbationConfig.empty(), BatchedPerturbationConfig.empty(1)):
        assert torch.equal(x0(video=video, perturbations=empty)[0], plain)


@pytest.mark.parametrize("which", ["batched_blocks", "all_blocks", "single"])
def test_port_x0model_refuses_stg_perturbations(which, rng):
    from mlx_video_tpu_torch.ltx_core.guidance.perturbations import (
        BatchedPerturbationConfig,
        Perturbation,
        PerturbationConfig,
        PerturbationType,
    )
    from mlx_video_tpu_torch.ltx_core.model.transformer import LTXModel, X0Model

    cfg, tcfg, model, _ = _tiny_dit(LTXModelType.VideoOnly)
    video = tm.Modality(**{k: torch.from_numpy(v) for k, v in _video_modality(cfg, rng).items()})
    skip = {
        "batched_blocks": BatchedPerturbationConfig([PerturbationConfig(
            [Perturbation(PerturbationType.SKIP_VIDEO_SELF_ATTN, [1])])]),
        "all_blocks": BatchedPerturbationConfig([PerturbationConfig.empty(), PerturbationConfig(
            [Perturbation(PerturbationType.SKIP_AUDIO_SELF_ATTN, None)])]),
        "single": PerturbationConfig([Perturbation(PerturbationType.SKIP_A2V_CROSS_ATTN, [0, 1])]),
    }[which]
    with pytest.raises(NotImplementedError, match="STG"):
        X0Model(LTXModel(tcfg, model))(video=video, perturbations=skip)
    # a perturbation of no block perturbs nothing
    none = PerturbationConfig([Perturbation(PerturbationType.SKIP_VIDEO_SELF_ATTN, [])])
    X0Model(LTXModel(tcfg, model))(video=video, perturbations=none)


def test_vae_classes_match_jax(rng):
    """The JAX adapters run under jax.jit (op by op, a narrow decoder takes
    seconds to dispatch); the tiled decode is held against JAX's tiling
    over the same jitted decoder."""
    from ltx_core.model.video_vae import VideoDecoder as JVideoDecoder, VideoEncoder as JVideoEncoder
    from mlx_video_tpu.models.ltx.video_vae.tiling import decode_with_tiling as jdecode_with_tiling
    from mlx_video_tpu_torch.ltx_core.model.video_vae import VideoDecoder, VideoEncoder
    from mlx_video_tpu_torch.ltx_core.model.video_vae.tiling import SpatialTilingConfig, TilingConfig

    blocks = (("res_x", {"num_layers": 1}), ("compress_space_res", {"multiplier": 2}),
              ("compress_time_res", {"multiplier": 1}), ("compress_all", {"multiplier": 1}),
              ("compress_all_res", {"multiplier": 1}))
    enc_kw = dict(out_channels=16, latent_channels=16, encoder_blocks=blocks)
    enc = VideoEncoder(tconfig.VideoVAEConfig(**enc_kw), generator=torch.Generator().manual_seed(1),
                       device="cpu")
    jenc = JVideoEncoder(JaxVAEConfig(**enc_kw), _jax(jax_bridge.encoder_to_jax_tree(enc.params)))
    clip = rng.uniform(-1, 1, size=(1, 3, 9, 64, 64)).astype(np.float32)
    lat = enc(torch.from_numpy(clip))
    assert lat.shape == (1, 16, 2, 2, 2)
    _fwd(lat, jax.jit(jenc)(jnp.asarray(clip)))

    # 32x in space and 8x in time, the scales the tiling assumes
    dec_kw = dict(in_channels=16, base_channels=32, num_layers_per_block=1, num_upsamples=3, patch_size=4)
    dec = VideoDecoder(DecoderConfig(**dec_kw), generator=torch.Generator().manual_seed(2), device="cpu")
    jdec = JVideoDecoder(JaxDecoderConfig(**dec_kw), _jax(jax_bridge.module_to_jax_tree(dec.params)))
    jdecode = jax.jit(lambda x: jdec(x, timestep=jnp.array([0.05])))
    z = rng.normal(size=(1, 16, 2, 3, 3)).astype(np.float32)
    px = dec(torch.from_numpy(z), timestep=torch.tensor([0.05]))
    assert px.shape == (1, 3, 9, 96, 96) and torch.isfinite(px).all()
    _fwd(px, jdecode(jnp.asarray(z)))
    tiling = TilingConfig(spatial_config=SpatialTilingConfig(tile_size_in_pixels=64, tile_overlap_in_pixels=32),
                          temporal_config=None)
    tiled = dec.decode_tiled(torch.from_numpy(z), tiling, timestep=torch.tensor([0.05]))
    assert tiled.shape == tuple(px.shape)
    _fwd(tiled, jdecode_with_tiling(jdecode, jnp.asarray(z), tiling))


def test_audio_classes_match_jax(rng):
    from ltx_core.model.audio_vae import (
        AudioDecoder as JAudioDecoder,
        AudioEncoder as JAudioEncoder,
        Vocoder as JVocoder,
    )
    from mlx_video_tpu_torch.ltx_core.model.audio_vae import AudioDecoder, AudioEncoder, Vocoder

    kw = dict(ch=16, ch_mult=(1, 2, 4), num_res_blocks=1, in_channels=2, out_ch=2, z_channels=4, mel_bins=16,
              resolution=64, decoder_attn_resolutions=(), mid_block_add_attention=True)
    enc = AudioEncoder(taudio.AudioVAEConfig(**kw), generator=torch.Generator().manual_seed(0), device="cpu")
    jenc = JAudioEncoder(JaxAudioVAEConfig(**kw), _jax(jax_bridge.audio_encoder_to_jax_tree(enc.params)))
    mel = rng.normal(size=(1, 2, 12, 16)).astype(np.float32)
    lat = enc(torch.from_numpy(mel))
    _fwd(lat, jax.jit(jenc)(jnp.asarray(mel)))
    dec = AudioDecoder(taudio.AudioVAEConfig(**kw), generator=torch.Generator().manual_seed(1), device="cpu")
    jdec = JAudioDecoder(JaxAudioVAEConfig(**kw), _jax(jax_bridge.audio_decoder_to_jax_tree(dec.params)))
    _fwd(dec(lat), jax.jit(jdec)(jnp.asarray(lat.numpy())))

    vkw = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 3),), upsample_initial_channel=32, stereo=True, mel_in_channels=8)
    voc = Vocoder(tvoc.VocoderConfig(**vkw), generator=torch.Generator().manual_seed(2), device="cpu")
    jvoc = JVocoder(JaxVocoderConfig(**vkw), _jax(jax_bridge.vocoder_to_jax_tree(voc.params)))
    spec = rng.normal(size=(1, 2, 10, 4)).astype(np.float32)
    wav = voc(torch.from_numpy(spec))
    assert torch.isfinite(wav).all()
    _fwd(wav, jax.jit(jvoc)(jnp.asarray(spec)))


def test_upsampler_class_matches_jax(rng):
    from ltx_core.model.upsampler import LatentUpsampler as JLatentUpsampler
    from ltx_core.model.upsampler.blur_downsample import blur_down as jblur
    from ltx_core.model.upsampler.pixel_shuffle import pixel_shuffle_2d as jshuffle
    from ltx_core.model.upsampler.spatial_rational_resampler import spatial_rational_resample as jresample
    from mlx_video_tpu_torch.ltx_core.model.upsampler import LatentUpsampler
    from mlx_video_tpu_torch.ltx_core.model.upsampler.blur_downsample import blur_down
    from mlx_video_tpu_torch.ltx_core.model.upsampler.pixel_shuffle import pixel_shuffle_2d
    from mlx_video_tpu_torch.ltx_core.model.upsampler.spatial_rational_resampler import spatial_rational_resample

    ups = LatentUpsampler(generator=torch.Generator().manual_seed(0), device="cpu", in_channels=16, mid_channels=32,
                          num_blocks=1)
    tree = _jax(jax_bridge.module_to_jax_tree(ups.params))
    lat = rng.normal(size=(1, 16, 2, 4, 4)).astype(np.float32)
    out = ups(torch.from_numpy(lat))
    assert out.shape == (1, 16, 2, 8, 8)
    _fwd(out, jax.jit(JLatentUpsampler(tree))(jnp.asarray(lat)))

    # the channels-first helpers against the JAX channels-last ones
    x = rng.normal(size=(2, 12, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(pixel_shuffle_2d(torch.from_numpy(x)).numpy(),
                                  np.asarray(jshuffle(jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2))
    _elem(blur_down(torch.from_numpy(x), 2), np.asarray(jblur(jnp.asarray(x.transpose(0, 2, 3, 1)), 2)).transpose(
        0, 3, 1, 2))
    x5 = rng.normal(size=(1, 32, 2, 4, 4)).astype(np.float32)
    for scale in (2.0, 1.0):
        got = spatial_rational_resample(ups.params.upsampler, torch.from_numpy(x5), scale)
        ref = jresample(tree["upsampler"], jnp.asarray(x5.transpose(0, 2, 3, 4, 1)), scale)
        _fwd(got, np.asarray(ref).transpose(0, 4, 1, 2, 3))


def test_fuse_loras_merges_like_jax(tmp_path, rng):
    """fuse_loras merges (the reference raised): the port's through
    lora.merge_lora_into_params on the DiT module, JAX's into its pytree,
    from one file."""
    from ltx_core.loader.fuse_loras import fuse_loras as jfuse
    from mlx_video_tpu.io.safetensors import save_safetensors
    from mlx_video_tpu_torch.ltx_core.loader.fuse_loras import fuse_loras
    from mlx_video_tpu_torch.ltx_core.loader.primitives import LoraPathStrengthAndSDOps

    cfg, _, model, params = _tiny_dit(LTXModelType.VideoOnly)
    inner = cfg.inner_dim
    a = rng.normal(size=(2, inner)).astype(np.float32)  # (r, in)
    b = rng.normal(size=(inner, 2)).astype(np.float32)  # (out, r)
    path = tmp_path / "l.safetensors"
    save_safetensors(path, {"transformer_blocks.0.attn1.to_q.lora_A.weight": a,
                            "transformer_blocks.0.attn1.to_q.lora_B.weight": b})
    w0 = model.blocks[0].attn1.to_q.weight.detach().clone()
    merged = fuse_loras(model, [LoraPathStrengthAndSDOps(path, 2.0)])
    ref = np.asarray(jfuse(params, [(path, 2.0)])["blocks"]["attn1"]["to_q"]["weight"][0])  # (in, out)
    got = merged.blocks[0].attn1.to_q.weight.detach()  # (out, in)
    np.testing.assert_allclose(got.numpy(), ref.T, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), (w0 + 2.0 * torch.from_numpy(b @ a)).numpy(), atol=1e-4)


# --- module tree and names ---

def _reference_modules(package: str):
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / package
    return sorted(".".join(p.relative_to(root.parent).with_suffix("").parts).removesuffix(".__init__")
                  for p in root.rglob("*.py"))


@pytest.mark.parametrize("package", ["ltx_core", "ltx_pipelines", "ltx_trainer"])
def test_every_reference_module_has_a_port_counterpart(package):
    """The file-for-file mirror: each reference module imports under
    mlx_video_tpu_torch with the same relative path, and exports every
    public name the reference module's ``__all__`` lists."""
    names = _reference_modules(package)
    assert len(names) == {"ltx_core": 85, "ltx_pipelines": 15, "ltx_trainer": 30}[package]
    for name in names:
        port = importlib.import_module(f"mlx_video_tpu_torch.{name}")
        ref = importlib.import_module(name)
        missing = [n for n in getattr(ref, "__all__", []) if not hasattr(port, n)]
        allowed = _RENAMED.get(name, set())
        assert set(missing) <= allowed, (name, missing)


# names whose JAX counterparts are parameter-pytree initialisers or
# channels-last layout moves; the port's modules take their place (the
# module classes each re-exporting file names)
_RENAMED = {
    "ltx_core.model.transformer.adaln": {"init_adaln"},
    "ltx_core.model.transformer.attention": {"init_attention"},
    "ltx_core.model.transformer.feed_forward": {"init_feed_forward"},
    "ltx_core.model.transformer.text_projection": {"init_text_projection"},
    "ltx_core.model.transformer.transformer": {"init_block"},
    "ltx_core.model.video_vae.convolution": {"conv2d", "init_conv2d", "init_conv3d"},
    "ltx_core.model.video_vae.decoder": {"init_time_embedder", "video_decoder_apply_chunked"},
    "ltx_core.model.video_vae.ops": {"to_channels_first", "to_channels_last"},
    "ltx_core.model.video_vae.resnet": {"init_resnet_block"},
    "ltx_core.model.video_vae.sampling": {"init_depth_to_space_upsample", "init_space_to_depth_downsample"},
    "ltx_core.model.audio_vae.attention": {"init_attn_block"},
    "ltx_core.model.audio_vae.causal_conv_2d": {"init_conv2d"},
    "ltx_core.model.audio_vae.downsample": {"init_downsample"},
    "ltx_core.model.audio_vae.ops": {"init_per_channel_statistics"},
    "ltx_core.model.audio_vae.resnet": {"init_resnet_block"},
    "ltx_core.model.audio_vae.upsample": {"init_upsample"},
    "ltx_core.model.upsampler.res_block": {"init_res_block_3d"},
    "ltx_core.text_encoders.gemma.embeddings_connector": {"init_connector"},
}


def test_reference_names_resolve():
    from mlx_video_tpu_torch.ltx_core.components.schedulers import BASE_SHIFT_ANCHOR, SchedulerProtocol  # noqa: F401
    from mlx_video_tpu_torch.ltx_core.conditioning import ConditioningItem  # noqa: F401
    from mlx_video_tpu_torch.ltx_core.conditioning.exceptions import ConditioningError
    from mlx_video_tpu_torch.ltx_core.loader.registry import DummyRegistry, Registry
    from mlx_video_tpu_torch.ltx_core.model import ModelConfigurator, ModelType  # noqa: F401
    from mlx_video_tpu_torch.ltx_core.tools import LatentTools, Patchifier  # noqa: F401

    r = Registry()
    r.register("x", 1)
    assert r.get("x") == 1 and DummyRegistry().get("missing") is None
    assert issubclass(ConditioningError, ValueError)
    with pytest.raises(AttributeError):
        from mlx_video_tpu_torch.ltx_core import conditioning

        conditioning.NotAName  # noqa: B018


def test_sft_loader_reads_the_file(tmp_path, rng):
    from ltx_core.loader.sft_loader import SafetensorsModelStateDictLoader as JLoader
    from mlx_video_tpu.io.safetensors import save_safetensors
    from mlx_video_tpu_torch.ltx_core.loader.sft_loader import SafetensorsModelStateDictLoader

    tensors = {"a.weight": rng.normal(size=(3, 4)).astype(np.float32), "b": np.arange(5, dtype=np.int32)}
    save_safetensors(tmp_path / "x.safetensors", tensors)
    got = SafetensorsModelStateDictLoader(tmp_path / "x.safetensors").load(device="cpu")
    ref = JLoader(tmp_path / "x.safetensors").load()
    assert set(got) == set(ref) == set(tensors)
    for k in tensors:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
