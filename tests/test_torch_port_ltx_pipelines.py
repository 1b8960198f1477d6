"""The port's ltx_pipelines and ltx_trainer (mlx_video_tpu_torch/ltx_pipelines/,
mlx_video_tpu_torch/ltx_trainer/) against the JAX package's, on the CPU: one
counterpart for each ltx_pipelines and ltx_trainer test of
tests/test_parity_packages.py, each feeding the same numpy inputs, made from
a seed, to the JAX function and to the port's; and the composed joint
audio-video denoise on a real 2-layer AudioVideo DiT.

Bars, each with its reason:
- fp32 elementwise pieces (loop arithmetic over a fake denoiser, guiders,
  masks, media normalisation): max |d| <= 1e-6 of the largest value (the
  same fp32 arithmetic);
- shapes, positions, argv, parser tables, captions, cut lists: exact;
- composed loops on the real DiT: >= 35 dB per latent frame (video frames,
  audio latent frames), the repo's pipeline gate
  (tests/test_torch_port_pipeline.py); its weights go to JAX through
  io/jax_bridge.py. On the JAX side the transformer is X0Model behind a
  test-side wrapper that drops ``perturbations``: JAX's X0Model raises on it
  (the reference defect pinned in tests/test_torch_port_ltx_core.py);
- samplers and strategies: repeatable, advancing per call, and equal to
  ``sample_sigmas``/``draw_inputs`` on the same generator (JAX's streams
  cannot be reproduced in torch).
"""

import dataclasses
import sys
import wave

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import ltx_pipelines as jpipes
from ltx_core import components as jcomp
from ltx_core import types as jtypes
from ltx_core.types import LatentState as JLatentState
from ltx_pipelines import bridge as jbridge
from ltx_pipelines.utils import args as jargs
from ltx_pipelines.utils import helpers as jh
from ltx_pipelines.utils import media_io as jmedia
from mlx_video_tpu.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch import ltx_pipelines as tpipes
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.ltx_core import components as tcomp
from mlx_video_tpu_torch.ltx_core import types as ttypes
from mlx_video_tpu_torch.ltx_core.types import LatentState
from mlx_video_tpu_torch.ltx_pipelines import bridge as tbridge
from mlx_video_tpu_torch.ltx_pipelines.utils import args as targs
from mlx_video_tpu_torch.ltx_pipelines.utils import helpers as th
from mlx_video_tpu_torch.ltx_pipelines.utils import media_io as tmedia
from mlx_video_tpu_torch.models.ltx import model as tm

ELEM_BAR = 1e-6


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _elem(got, ref, bar: float = ELEM_BAR) -> None:
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= bar * max(float(np.abs(ref).max()), 1e-30)


def psnr(a, b, peak: float) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _min_frame_psnr(got, ref) -> float:
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    peak = float(np.abs(ref).max())
    return min(psnr(got[:, :, i], ref[:, :, i], peak) for i in range(ref.shape[2]))


def _states(rng, v_shape=(1, 8, 4), a_shape=(1, 4, 4), positions=False):
    v = rng.normal(size=v_shape).astype(np.float32)
    a = rng.normal(size=a_shape).astype(np.float32)

    def mk(lat, cls, lib):
        arr = (jnp.asarray if lib == "jax" else torch.from_numpy)
        pos = arr(np.zeros((1, 3, lat.shape[1], 2), np.float32)) if positions else None
        return cls(latent=arr(lat), clean_latent=arr(np.zeros_like(lat)),
                   denoise_mask=arr(np.ones_like(lat[..., :1])), positions=pos)

    return (mk(v, JLatentState, "jax"), mk(a, JLatentState, "jax")), (mk(v, LatentState, "torch"),
                                                                       mk(a, LatentState, "torch"))


# --- loops over a fake denoiser ---

@pytest.mark.parametrize("loop", ["euler_denoising_loop", "gradient_estimating_euler_denoising_loop"])
def test_loops_match_jax(loop, rng):
    (jv, ja), (tv, ta) = _states(rng)
    sigmas = np.array([1.0, 0.6, 0.3, 0.0], dtype=np.float32)
    jout = getattr(jh, loop)(sigmas, jv, ja, jcomp.EulerDiffusionStep(), lambda v, a, s, i: (v.latent * 0.9, a.latent * 0.5))
    tout = getattr(th, loop)(sigmas, tv, ta, tcomp.EulerDiffusionStep(), lambda v, a, s, i: (v.latent * 0.9, a.latent * 0.5))
    for j, t in zip(jout, tout):
        assert t.latent.shape == tuple(j.latent.shape) and torch.isfinite(t.latent).all()
        _elem(t.latent, j.latent)


def test_state_helpers_match_jax(rng):
    """post_process_latent, timesteps_from_mask, modality_from_latent_state
    and noise_state (with one fixed noise for both sides)."""
    (jv, _), (tv, _) = _states(rng, positions=True)
    mask = rng.uniform(size=(1, 8, 1)).astype(np.float32)
    clean = rng.normal(size=(1, 8, 4)).astype(np.float32)
    _elem(th.post_process_latent(tv.latent, torch.from_numpy(mask), torch.from_numpy(clean)),
          jh.post_process_latent(jv.latent, jnp.asarray(mask), jnp.asarray(clean)))
    _elem(th.timesteps_from_mask(torch.from_numpy(mask), np.float32(0.7)), jh.timesteps_from_mask(jnp.asarray(mask),
                                                                                                 np.float32(0.7)))
    ctx = rng.normal(size=(1, 3, 4)).astype(np.float32)
    tmod = th.modality_from_latent_state(dataclasses.replace(tv, denoise_mask=torch.from_numpy(mask)),
                                         torch.from_numpy(ctx), np.float32(0.7))
    jmod = jh.modality_from_latent_state(dataclasses.replace(jv, denoise_mask=jnp.asarray(mask)), jnp.asarray(ctx),
                                         np.float32(0.7))
    _elem(tmod.timesteps, jmod.timesteps)
    assert isinstance(tmod, tm.Modality) and tmod.latent is tv.latent and tmod.context_mask is None
    assert th.modality_from_latent_state(tv, torch.from_numpy(ctx), 0.5, enabled=False) is None
    noise = rng.normal(size=(1, 8, 4)).astype(np.float32)

    class Fixed:
        def __init__(self, arr):
            self.arr = arr

        def noise(self, latents):
            return self.arr

    tn = th.noise_state(dataclasses.replace(tv, denoise_mask=torch.from_numpy(mask)), Fixed(torch.from_numpy(noise)),
                        0.6)
    jn = jh.noise_state(dataclasses.replace(jv, denoise_mask=jnp.asarray(mask)), Fixed(jnp.asarray(noise)), 0.6)
    _elem(tn.latent, jn.latent)


def test_assert_resolution_matches_jax():
    for h, w, two in ((512, 768, True), (500, 768, False), (544, 800, True), (544, 800, False)):
        outcomes = []
        for fn in (th.assert_resolution, jh.assert_resolution):
            try:
                fn(h, w, is_two_stage=two)
                outcomes.append("ok")
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], (h, w, two)
    with pytest.raises(ValueError):
        th.assert_resolution(500, 768, is_two_stage=False)


def test_get_device_and_cleanup():
    if torch.cuda.is_available():
        assert th.get_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            th.get_device()
    th.cleanup_memory()


# --- wrappers, the bridge, the CLI entries ---

PIPELINES = ["DistilledPipeline", "ICLoraPipeline", "KeyframeInterpolationPipeline", "TI2VidOneStage",
             "TI2VidTwoStages"]


def test_pipeline_wrappers_construct_like_jax():
    for name in PIPELINES:
        t, j = getattr(tpipes, name)(), getattr(jpipes, name)()
        tf, jf = dataclasses.asdict(t), dataclasses.asdict(j)
        assert tf.pop("device") == "cuda" and tf == jf, name
    assert tpipes.DistilledPipeline(height=64).height == 64 and tpipes.TI2VidOneStage().steps == 40
    assert tpipes.TI2VidTwoStagesPipeline is tpipes.TI2VidTwoStages
    assert tpipes.TI2VidOneStagePipeline is tpipes.TI2VidOneStage
    tcfg, jcfg = dataclasses.asdict(tbridge.TPUPipelineConfig()), dataclasses.asdict(jbridge.TPUPipelineConfig())
    assert tcfg.pop("device") == "cuda" and tcfg == jcfg
    assert tbridge.MLXPipelineConfig is tbridge.TPUPipelineConfig


def _call(name, mod, **kw):
    cls = getattr(mod, name)
    common = dict(prompt="a cat", output_path="o.mp4", negative_prompt="blurry")
    if name == "ICLoraPipeline":
        return cls(seed=3, **kw)(video_conditionings=[("ref.mp4", 0.7), "r2.mp4"], loras=[("l.safetensors", 0.5)],
                                 **common)
    if name == "KeyframeInterpolationPipeline":
        return cls(height=256, **kw)(keyframes=[("a.png", 0, 1.0), ("b.png", 32, 0.8)], **common)
    if name == "TI2VidOneStage":
        return cls(steps=12, audio=True, **kw)(images=[("i.png",)], loras=["l1.safetensors"], **common)
    return cls(num_frames=65, **kw)(images=["i.png"], distilled_lora=[("d.safetensors", 0.8)], **common)


@pytest.mark.parametrize("name", PIPELINES)
def test_run_generate_argv_matches_jax(name, monkeypatch):
    """Each wrapper's argv, with generate_main intercepted in both
    packages: the port's is JAX's plus ``--device``."""
    import mlx_video_tpu.cli.generate as jcli
    import mlx_video_tpu_torch.cli.generate as tcli

    seen = {}
    monkeypatch.setattr(jcli, "main", lambda argv=None: seen.setdefault("jax", list(argv)))
    monkeypatch.setattr(tcli, "main", lambda argv=None: seen.setdefault("torch", list(argv)))
    assert _call(name, jpipes) == _call(name, tpipes) == "o.mp4"
    assert seen["torch"] == seen["jax"] + ["--device", "cuda"]
    seen.clear()
    _call(name, jpipes)
    _call(name, tpipes, device="cpu")
    assert seen["torch"] == seen["jax"] + ["--device", "cpu"]


@pytest.mark.parametrize("module", ["distilled", "ic_lora", "keyframe_interpolation", "ti2vid_one_stage",
                                    "ti2vid_two_stages"])
def test_run_cli_appends_the_pipeline_like_jax(module, monkeypatch):
    import importlib

    import mlx_video_tpu.cli.generate as jcli
    import mlx_video_tpu_torch.cli.generate as tcli

    seen = {}
    monkeypatch.setattr(jcli, "main", lambda argv=None: seen.setdefault("jax", (argv, list(sys.argv))))
    monkeypatch.setattr(tcli, "main", lambda argv=None: seen.setdefault("torch", (argv, list(sys.argv))))
    for lib, prefix in (("jax", ""), ("torch", "mlx_video_tpu_torch.")):
        monkeypatch.setattr(sys, "argv", ["prog", "--prompt", "x"])
        importlib.import_module(f"{prefix}ltx_pipelines.{module}").main()
    assert seen["torch"] == seen["jax"] and seen["torch"][0] is None
    assert seen["torch"][1][-2] == "--pipeline"
    monkeypatch.setattr(sys, "argv", ["prog", "--pipeline", "dev"])
    seen.clear()
    importlib.import_module(f"mlx_video_tpu_torch.ltx_pipelines.{module}").main()
    assert seen["torch"][1] == ["prog", "--pipeline", "dev"]


def test_bridge_normalizers_match_jax():
    loras = ["a.st", ("b.st", 0.5), ["c.st"]]
    images = [("img.png", 3, 0.9), "x.png", ["y.png"]]
    videos = [("v.mp4", 2, 0.5), ("w.mp4", 0.3), "z.mp4"]
    assert tbridge.normalize_loras(loras) == jbridge.normalize_loras(loras) == [("a.st", 1.0), ("b.st", 0.5),
                                                                              ("c.st", 1.0)]
    assert tbridge.normalize_images(images) == jbridge.normalize_images(images)
    assert tbridge.normalize_video_conditions(videos) == jbridge.normalize_video_conditions(videos)
    assert tbridge.normalize_loras(None) == []


def test_pipeline_mains_and_names_exist():
    import mlx_video_tpu_torch.ltx_pipelines.distilled as d
    import mlx_video_tpu_torch.ltx_pipelines.ic_lora as i
    import mlx_video_tpu_torch.ltx_pipelines.keyframe_interpolation as k
    import mlx_video_tpu_torch.ltx_pipelines.ti2vid_one_stage as o
    import mlx_video_tpu_torch.ltx_pipelines.ti2vid_two_stages as t
    from mlx_video_tpu_torch.ltx_pipelines import ModelLedger, TI2VidOneStagePipeline  # noqa: F401
    from mlx_video_tpu_torch.ltx_pipelines.utils.constants import (  # noqa: F401
        DEFAULT_IMAGE_CRF, DEFAULT_LORA_STRENGTH, DEFAULT_NEGATIVE_PROMPT,
    )

    for mod in (d, i, k, o, t):
        assert callable(mod.main)
    ledger = ModelLedger("/nonexistent", pipeline="dev", loras=[("a.safetensors", 0.5)])
    assert ledger.device == "cuda" and ledger.with_loras([]).loras == [] and ledger.with_loras([]).device == "cuda"


# --- trainer ---

def test_trainer_shims_import():
    import mlx_video_tpu_torch.ltx_trainer as t
    from mlx_video_tpu_torch.ltx_trainer import (  # noqa: F401
        config, config_display, datasets, gpu_utils, hf_hub_utils, model_loader, progress, quantization, utils,
        validation_sampler, video_utils,
    )
    from mlx_video_tpu_torch.trainer import trainer as engine

    assert t.Trainer is engine.Trainer and t.TrainingConfig is config.TrainingConfig
    from mlx_video_tpu_torch.ltx_trainer.trainer import MLXTrainer, Trainer

    assert MLXTrainer is Trainer


def test_scripts_importable_and_network_parts_refused(tmp_path):
    from mlx_video_tpu_torch.ltx_trainer import captioning, hf_hub_utils
    from mlx_video_tpu_torch.ltx_trainer.scripts import (  # noqa: F401
        caption_videos, compute_reference, decode_latents, inference, process_captions, process_dataset,
        process_videos, split_scenes, train,
    )

    for call in (lambda: captioning.Captioner().caption(np.zeros((8, 8, 3), np.uint8)),
                 lambda: hf_hub_utils.push_to_hub(tmp_path, "x/y")):
        with pytest.raises(NotImplementedError):
            call()
    (tmp_path / "v").mkdir()
    cv2.imwrite(str(tmp_path / "f.png"), np.zeros((8, 8, 3), np.uint8))
    _write_clip(tmp_path / "v" / "a.mp4", 4)
    with pytest.raises(NotImplementedError):
        caption_videos.main(["--videos", str(tmp_path / "v"), "--output", str(tmp_path / "p.txt")])


def _write_clip(path, frames, seed=0, noise_from=None):
    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 24, (64, 64))
    for i in range(frames):
        if noise_from is not None and i >= noise_from:
            w.write((rng.uniform(size=(64, 64, 3)) * 255).astype(np.uint8))
        else:
            w.write(np.zeros((64, 64, 3), np.uint8))
    w.release()


def test_scene_cut_detection_matches_jax(tmp_path):
    from ltx_trainer.scripts.split_scenes import detect_scene_cuts as jcuts
    from mlx_video_tpu_torch.ltx_trainer.scripts.split_scenes import detect_scene_cuts

    path = tmp_path / "scene.mp4"
    _write_clip(path, 40, noise_from=20)
    cuts = detect_scene_cuts(path, threshold=0.5)
    assert cuts == jcuts(path, threshold=0.5)
    assert len(cuts) >= 3 and any(18 <= c <= 22 for c in cuts[1:-1])


def test_caption_and_dataset_scripts_match_jax(tmp_path):
    from ltx_trainer.scripts import process_captions as jcap, process_dataset as jdata
    from mlx_video_tpu_torch.ltx_trainer.scripts import process_captions, process_dataset

    src = tmp_path / "caps.json"
    src.write_text('{"clips/a.mp4": "a cat", "b.mp4": "a dog"}')
    for mod, out in ((jcap, "j.txt"), (process_captions, "t.txt")):
        mod.main(["--input", str(src), "--output", str(tmp_path / out), "--prefix", "STYLE "])
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    (tmp_path / "vids").mkdir()
    _write_clip(tmp_path / "vids" / "a.mp4", 2)
    mapping = tmp_path / "map.json"
    mapping.write_text('[{"video": "a.mp4", "caption": "x"}, {"video": "missing.mp4"}]')
    for mod, out in ((jdata, "jd"), (process_dataset, "td")):
        mod.main(["--mapping", str(mapping), "--videos-root", str(tmp_path / "vids"), "--output", str(tmp_path / out)])
    assert (tmp_path / "td" / "prompts.txt").read_text() == (tmp_path / "jd" / "prompts.txt").read_text()


def test_timestep_samplers():
    """Repeatable per seed, advancing per call, and each draw the port's
    ``sample_sigmas`` on a generator of the same seed."""
    from mlx_video_tpu_torch.ltx_trainer.timestep_samplers import (
        SAMPLERS,
        ShiftedLogitNormalSampler,
        UniformSampler,
        get_timestep_sampler,
    )
    from mlx_video_tpu_torch.trainer.strategies import sample_sigmas

    lat = torch.zeros(3, 10, 4)
    for mode, std in (("uniform", 1.0), ("shifted_logit_normal", 0.5)):
        s = get_timestep_sampler(mode, std=std)
        assert isinstance(s, ShiftedLogitNormalSampler if mode != "uniform" else UniformSampler)
        a, b = s.sample_for(lat), s.sample_for(lat, seq_len=4096)
        again = get_timestep_sampler(mode, std=std)
        assert torch.equal(again.sample_for(lat), a) and not torch.equal(a, b)
        g = torch.Generator().manual_seed(0)
        assert torch.equal(a, sample_sigmas(g, 3, 10, mode, std).reshape(3, 1, 1))
        assert torch.equal(b, sample_sigmas(g, 3, 4096, mode, std).reshape(3, 1, 1))
        assert a.shape == (3, 1, 1) and bool(((a > 0) & (a < 1)).all())
    assert set(SAMPLERS) == {"uniform", "shifted_logit_normal"}


def test_training_strategies(rng):
    """Sources as JAX's; prepare_training_inputs is the port's
    draw_inputs + make_inputs on the strategy's generator, advancing per
    call; an explicit sampler picks the distribution."""
    from ltx_trainer.training_strategies import text_to_video as jt2v, video_to_video as jv2v
    from mlx_video_tpu_torch.ltx_trainer.timestep_samplers import ShiftedLogitNormalSampler
    from mlx_video_tpu_torch.ltx_trainer.training_strategies import get_training_strategy
    from mlx_video_tpu_torch.ltx_trainer.training_strategies.base_strategy import TrainingStrategy
    from mlx_video_tpu_torch.ltx_trainer.training_strategies.text_to_video import TextToVideoStrategy
    from mlx_video_tpu_torch.ltx_trainer.training_strategies.video_to_video import VideoToVideoStrategy
    from mlx_video_tpu_torch.trainer.config import TrainingConfig
    from mlx_video_tpu_torch.trainer.datasets import Batch
    from mlx_video_tpu_torch.trainer.strategies import draw_inputs, make_inputs, prepare_text_to_video
    from mlx_video_tpu.trainer.config import TrainingConfig as JTrainingConfig

    t2v = TextToVideoStrategy(TrainingConfig(with_audio=True, seed=3))
    assert t2v.requires_audio and isinstance(t2v, TrainingStrategy)
    assert t2v.get_data_sources() == jt2v.TextToVideoStrategy(JTrainingConfig(with_audio=True)).get_data_sources()
    assert VideoToVideoStrategy(TrainingConfig()).get_data_sources() == \
        jv2v.VideoToVideoStrategy(JTrainingConfig()).get_data_sources()
    assert isinstance(get_training_strategy("ic_lora"), VideoToVideoStrategy)
    assert isinstance(get_training_strategy(TrainingConfig()), TextToVideoStrategy)

    batch = Batch(latents={"latents": rng.normal(size=(1, 8, 2, 2, 2)).astype(np.float32), "num_frames": 2,
                           "height": 2, "width": 2, "fps": 24.0},
                  conditions={"prompt_embeds": rng.normal(size=(1, 5, 16)).astype(np.float32),
                              "prompt_attention_mask": np.ones((1, 5), np.int64)})
    s = TextToVideoStrategy(TrainingConfig(seed=3))
    first, second = s.prepare_training_inputs(batch, device="cpu"), s.prepare_training_inputs(batch, device="cpu")
    g = torch.Generator().manual_seed(3)
    sb = prepare_text_to_video(batch)
    want = [make_inputs(sb, draw_inputs(sb, g)) for _ in range(2)]
    for got, ref in zip((first, second), want):
        assert torch.equal(got.video.latent, ref.video.latent) and torch.equal(got.video_targets, ref.video_targets)
    assert not torch.equal(first.video.latent, second.video.latent)
    shifted = TextToVideoStrategy(TrainingConfig(seed=3)).prepare_training_inputs(
        batch, timestep_sampler=ShiftedLogitNormalSampler(std=0.5), device="cpu")
    ref = make_inputs(sb, draw_inputs(sb, torch.Generator().manual_seed(3), timestep_sampling_mode="shifted_logit_normal",
                                      timestep_sampling_std=0.5))
    assert torch.equal(shifted.video.timesteps, ref.video.timesteps)
    loss = s.compute_loss(first.video_targets, None, first)
    assert float(loss) == 0.0


# --- media IO ---

def test_resize_and_center_crop_matches_jax():
    img = np.random.default_rng(0).uniform(0, 255, (30, 50, 3)).astype(np.float32)
    vid = np.random.default_rng(1).uniform(0, 255, (4, 30, 50, 3)).astype(np.float32)
    for x, hw, shape in ((img, (16, 16), (1, 3, 1, 16, 16)), (vid, (16, 24), (1, 3, 4, 16, 24))):
        out = tmedia.resize_and_center_crop(x, *hw)
        assert out.shape == shape
        np.testing.assert_array_equal(out, jmedia.resize_and_center_crop(x, *hw))
    with pytest.raises(ValueError):
        tmedia.resize_and_center_crop(np.zeros((3, 4)), 8, 8)


def test_resize_aspect_ratio_preserving_matches_jax():
    img = np.random.default_rng(0).uniform(0, 255, (30, 60, 3)).astype(np.float32)
    out = tmedia.resize_aspect_ratio_preserving(img, 20)
    assert out.shape == (10, 20, 3)
    np.testing.assert_array_equal(out, jmedia.resize_aspect_ratio_preserving(img, 20))
    np.testing.assert_array_equal(tmedia.resize_aspect_ratio_preserving(torch.from_numpy(img), 20), out)


def test_normalize_latent_matches_jax():
    x = np.array([0.0, 63.75, 127.5, 255.0])
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        out = tmedia.normalize_latent(x, dtype, device="cpu")
        assert out.dtype == dtype
        _elem(out, jmedia.normalize_latent(x, jdtype))
    np.testing.assert_allclose(tmedia.normalize_latent(x[[0, 2, 3]], torch.float32, device="cpu").numpy(),
                               [-1.0, 0.0, 1.0], atol=1e-6)


@pytest.mark.parametrize("form", ["iterator", "list"])
def test_encode_video_chunks_and_decode(form, tmp_path):
    rng = np.random.default_rng(0)
    chunks = [rng.integers(0, 255, (3, 32, 32, 3), dtype=np.uint8) for _ in range(2)]
    out = tmp_path / "vid.mp4"
    tmedia.encode_video(iter(chunks) if form == "iterator" else chunks, 8.0, None, None, str(out), 2)
    assert out.exists() and out.stat().st_size > 0
    frames = list(tmedia.decode_video_from_file(str(out), frame_cap=4))
    ref = list(jmedia.decode_video_from_file(str(out), frame_cap=4))
    assert len(frames) == 4 and frames[0].shape == (1, 32, 32, 3)
    for a, b in zip(frames, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmedia.decode_single_frame(str(out)), jmedia.decode_single_frame(str(out)))
    with pytest.raises(ValueError, match="no frames"):
        tmedia.encode_video(iter([]), 8.0, None, None, str(tmp_path / "e.mp4"), 0)
    with pytest.raises(ValueError, match="output_path"):
        tmedia.encode_video(chunks, 8.0)


def test_encode_video_engine_layout_and_audio_track(tmp_path):
    rng = np.random.default_rng(0)
    video = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 4, 32, 32)).astype(np.float32))
    audio = rng.uniform(-0.5, 0.5, (2400, 2)).astype(np.float32)
    out = tmp_path / "av.mp4"
    tmedia.encode_video(video, 8.0, torch.from_numpy(audio), 24000, str(out), 1)
    # without ffmpeg the mux falls back to the video alone; the container exists either way
    assert out.exists() and out.stat().st_size > 0
    assert len(list(tmedia.decode_video_from_file(str(out), frame_cap=-1))) == 4
    with pytest.raises(ValueError, match="audio_sample_rate"):
        tmedia.encode_video(video, 8.0, audio, None, str(tmp_path / "x.mp4"))


def test_decode_image_grayscale_matches_jax(tmp_path):
    p = tmp_path / "gray.png"
    Image.fromarray(np.arange(200, dtype=np.uint8).reshape(10, 20), mode="L").save(p)
    out = tmedia.decode_image(str(p))
    assert out.shape == (10, 20, 3)
    np.testing.assert_array_equal(out, jmedia.decode_image(str(p)))


@pytest.mark.parametrize("layout", ["n2", "2n", "mono"])
def test_wav_roundtrip_matches_jax(layout, tmp_path):
    rng = np.random.default_rng(0)
    audio = rng.uniform(-0.5, 0.5, {"n2": (1000, 2), "2n": (2, 1000), "mono": (1000,)}[layout]).astype(np.float32)
    wav = tmp_path / "a.wav"
    tmedia._write_wav(str(wav), audio, 16000)
    back = tmedia.decode_audio_from_file(str(wav), device="cpu")
    ref = jmedia.decode_audio_from_file(str(wav))
    assert isinstance(back, torch.Tensor) and back.shape == (1000, 2) and back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref))
    want = audio.T if layout == "2n" else (audio[:, None].repeat(2, 1) if layout == "mono" else audio)
    np.testing.assert_allclose(back.numpy(), want, atol=1e-3)
    with wave.open(str(wav)) as w:
        assert (w.getnchannels(), w.getframerate()) == (2, 16000)


def test_preprocess_matches_jax():
    img = np.random.default_rng(0).integers(0, 255, (32, 32, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tmedia.preprocess(img, crf=0), img)
    odd = np.random.default_rng(0).integers(0, 255, (33, 35, 3)).astype(np.uint8)
    out = tmedia.preprocess(odd, crf=33)
    # the crf round trip crops to even dims (reference: media_io.py:268-270)
    assert out.shape[2] == 3 and out.shape[0] in (32, 33) and out.shape[1] in (34, 35)
    assert out.shape == jmedia.preprocess(odd, crf=33).shape


def test_load_image_conditioning_matches_jax(tmp_path):
    img_path = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (40, 48, 3), dtype=np.uint8)).save(img_path)
    out = tmedia.load_image_conditioning(str(img_path), 32, 32, torch.float32, device="cpu")
    assert out.shape == (1, 3, 1, 32, 32) and out.device.type == "cpu"
    assert float(out.abs().max()) <= 1.0 + 1e-6
    _elem(out, jmedia.load_image_conditioning(str(img_path), 32, 32, jnp.float32))
    clip = tmp_path / "clip.mp4"
    tmedia.encode_video([np.random.default_rng(1).integers(0, 255, (3, 32, 32, 3), dtype=np.uint8)], 8.0,
                        output_path=str(clip))
    vid = tmedia.load_video_conditioning(str(clip), 16, 16, 2, torch.float32, device="cpu")
    assert vid.shape == (1, 3, 2, 16, 16)
    _elem(vid, jmedia.load_video_conditioning(str(clip), 16, 16, 2, jnp.float32))


# --- argument parsers ---

def _table(parser):
    import argparse

    out = {}
    for a in parser._actions:
        if not a.option_strings or a.option_strings == ["-h", "--help"]:
            continue
        nargs = 0 if isinstance(a, argparse._StoreTrueAction) else a.nargs
        out[a.option_strings[0]] = (nargs, bool(a.required), a.default, a.dest, a.metavar)
    return out


@pytest.mark.parametrize("factory", ["basic_arg_parser", "default_1_stage_arg_parser", "default_2_stage_arg_parser",
                                     "default_2_stage_distilled_arg_parser"])
def test_parsers_match_jax(factory):
    t, j = _table(getattr(targs, factory)()), _table(getattr(jargs, factory)())
    assert t == j
    assert t["--seed"][2] == 10 and t["--lora"][0] == "+"


def test_actions_accumulate_like_jax(tmp_path):
    from mlx_video_tpu_torch.ltx_core.loader import LoraPathStrengthAndSDOps

    argv = ["--checkpoint-path", str(tmp_path / "m.safetensors"), "--gemma-root", str(tmp_path), "--prompt", "p",
            "--output-path", str(tmp_path / "o.mp4"), "--image", "a.png", "0", "0.8", "--image", "b.png", "8", "0.9",
            "--lora", "l1.safetensors", "0.5", "--lora", "l2.safetensors", "--distilled-lora", "d.safetensors",
            "--spatial-upsampler-path", str(tmp_path / "u.safetensors")]
    t, j = targs.default_2_stage_arg_parser().parse_args(argv), jargs.default_2_stage_arg_parser().parse_args(argv)
    assert t.images == j.images and len(t.images) == 2 and t.images[1][2] == 0.9
    assert [(str(x.path), x.strength) for x in t.lora] == [(str(x.path), x.strength) for x in j.lora]
    assert all(isinstance(x, LoraPathStrengthAndSDOps) for x in t.lora)
    assert [x.strength for x in t.lora] == [0.5, 1.0] and len(t.distilled_lora) == 1
    with pytest.raises(SystemExit):
        targs.default_1_stage_arg_parser().parse_args(["--checkpoint-path", "m", "--gemma-root", "g", "--prompt", "p",
                                                       "--output-path", "o", "--lora", "a", "0.5", "extra"])


# --- composed helpers ---

def _fake_encoder(lib):
    def enc(pixels):
        b, c, f, h, w = pixels.shape
        pooled = pixels.reshape(b, c, f, h // 32, 32, w // 32, 32).mean((4, 6))
        return (jnp.concatenate([pooled] * 3, axis=1) if lib == "jax" else torch.cat([pooled] * 3, dim=1))[:, :8]

    return enc


def test_image_conditionings_factories_match_jax(rng, tmp_path):
    from mlx_video_tpu_torch.ltx_core.conditioning import VideoConditionByKeyframeIndex, VideoConditionByLatentIndex
    from mlx_video_tpu_torch.pipelines import conditioning as engine

    path = tmp_path / "img.png"
    Image.fromarray((rng.random((64, 64, 3)) * 255).astype(np.uint8)).save(path)
    for factory, cls, eng, attr in (
        ("image_conditionings_by_replacing_latent", VideoConditionByLatentIndex, engine.VideoConditionByLatentIndex,
         "latent"),
        ("image_conditionings_by_adding_guiding_latent", VideoConditionByKeyframeIndex,
         engine.VideoConditionByKeyframeIndex, "keyframes"),
    ):
        (got,) = getattr(th, factory)([(str(path), 2, 0.9)], 64, 64, _fake_encoder("torch"), torch.float32,
                                      device="cpu")
        (ref,) = getattr(jh, factory)([(str(path), 2, 0.9)], 64, 64, _fake_encoder("jax"), jnp.float32)
        assert isinstance(got, cls) and isinstance(got, eng)
        assert (got.frame_idx, got.strength) == (ref.frame_idx, ref.strength) == (2, 0.9)
        assert getattr(got, attr).shape == (1, 8, 1, 2, 2)
        _elem(getattr(got, attr), getattr(ref, attr))


def test_state_with_conditionings_matches_jax(rng):
    from ltx_core.conditioning import VideoConditionByKeyframeIndex as JK, VideoConditionByLatentIndex as JL
    from ltx_core.tools import VideoLatentTools as JTools
    from mlx_video_tpu_torch.ltx_core.conditioning import VideoConditionByKeyframeIndex, VideoConditionByLatentIndex
    from mlx_video_tpu_torch.ltx_core.tools import VideoLatentTools

    shape = ttypes.VideoLatentShape(1, 8, 2, 4, 4)
    init = rng.normal(size=shape.to_shape()).astype(np.float32)
    c1, c2 = (rng.normal(size=(1, 8, 1, 4, 4)).astype(np.float32) for _ in range(2))
    tt, jt = VideoLatentTools(target_shape=shape), JTools(target_shape=jtypes.VideoLatentShape(*shape))
    ts = tt.patchify(tt.create_initial_state(initial_latent=torch.from_numpy(init), device="cpu"))
    tout = th.state_with_conditionings(ts, [VideoConditionByLatentIndex(latent=torch.from_numpy(c1), frame_idx=1,
                                                                        strength=0.8),
                                            VideoConditionByKeyframeIndex(keyframes=torch.from_numpy(c2), frame_idx=0,
                                                                          strength=1.0)], tt)
    names = ("latent", "clean_latent", "denoise_mask", "positions")

    @jax.jit  # one dispatch: JAX's op-by-op path compiles each op on first use
    def japply(init, c1, c2):
        js = jt.patchify(jt.create_initial_state(initial_latent=init))
        out = jh.state_with_conditionings(js, [JL(latent=c1, frame_idx=1, strength=0.8),
                                               JK(keyframes=c2, frame_idx=0, strength=1.0)], jt)
        return tuple(getattr(out, name) for name in names)

    jout = japply(jnp.asarray(init), jnp.asarray(c1), jnp.asarray(c2))
    for name, ref in zip(names, jout):
        _elem(getattr(tout, name), ref)
    assert tout.latent.shape == (1, 64, 8)
    np.testing.assert_allclose(tout.denoise_mask[:, 32:48].numpy(), 0.2, atol=1e-6)
    # a frame-0 keyframe takes pixel coordinates with the causal fix: its
    # positions are the state's first-frame block
    np.testing.assert_allclose(tout.positions[:, :, 48:].numpy(), ts.positions[:, :, :16].numpy(), atol=1e-6)
    assert tt.clear_conditioning(tout).positions.shape == (1, 3, 32, 2)


def test_denoising_funcs_match_jax_on_a_fake_transformer(rng):
    (jv, ja), (tv, ta) = _states(rng, v_shape=(1, 6, 4), a_shape=(1, 3, 4), positions=True)
    ctx_p, ctx_n = np.ones((1, 2, 4), np.float32), np.zeros((1, 2, 4), np.float32)

    def fake(lib):
        mean = jnp.mean if lib == "jax" else torch.mean

        def transformer(video=None, audio=None, perturbations=None):
            assert perturbations is None
            scale = mean(video.context)
            return video.latent * (0.5 + scale), audio.latent * (0.5 + scale)

        return transformer

    sigmas = np.array([1.0, 0.0], dtype=np.float32)
    tp, tn, jp, jn = torch.from_numpy(ctx_p), torch.from_numpy(ctx_n), jnp.asarray(ctx_p), jnp.asarray(ctx_n)
    got = th.simple_denoising_func(tp, tp, fake("torch"))(tv, ta, sigmas, 0)
    ref = jh.simple_denoising_func(jp, jp, fake("jax"))(jv, ja, sigmas, 0)
    for g, r in zip(got, ref):
        _elem(g, r)
    np.testing.assert_allclose(got[0].numpy(), tv.latent.numpy() * 1.5, atol=1e-6)
    for guider in ("CFGGuider", "CFGStarRescalingGuider", "LtxAPGGuider"):
        got = th.guider_denoising_func(getattr(tcomp, guider)(4.0), tp, tn, tp, tn, fake("torch"))(tv, ta, sigmas, 0)
        ref = jh.guider_denoising_func(getattr(jcomp, guider)(4.0), jp, jn, jp, jn, fake("jax"))(jv, ja, sigmas, 0)
        for g, r in zip(got, ref):
            _elem(g, r)
    cond, uncond = tv.latent.numpy() * 1.5, tv.latent.numpy() * 0.5
    got = th.guider_denoising_func(tcomp.CFGGuider(4.0), tp, tn, tp, tn, fake("torch"))(tv, ta, sigmas, 0)
    np.testing.assert_allclose(got[0].numpy(), cond + 3.0 * (cond - uncond), atol=1e-5)


def test_denoise_audio_video_composed_fake_transformer(rng):
    """The composed AV denoise on a fake transformer and JAX's initial
    latents (``noise_scale=0``): the same states on both sides."""
    from ltx_core.conditioning import VideoConditionByLatentIndex as JL
    from ltx_pipelines.utils.types import PipelineComponents as JComponents
    from mlx_video_tpu_torch.ltx_core.conditioning import VideoConditionByLatentIndex
    from mlx_video_tpu_torch.ltx_pipelines.utils.types import PipelineComponents

    out_shape = ttypes.VideoPixelShape(batch=1, frames=9, height=64, width=64, fps=24.0)
    cond = rng.normal(size=(1, 8, 1, 2, 2)).astype(np.float32)
    v0 = rng.normal(size=(1, 8, 2, 2, 2)).astype(np.float32)
    a_shape = ttypes.AudioLatentShape.from_video_pixel_shape(out_shape)
    a0 = rng.normal(size=a_shape.to_shape()).astype(np.float32)
    sigmas = np.array([1.0, 0.5, 0.0], dtype=np.float32)

    def fake(video=None, audio=None, perturbations=None):
        return video.latent * 0.5, audio.latent * 0.5

    tcomps, jcomps = PipelineComponents(dtype=torch.float32, device="cpu"), JComponents(dtype=jnp.float32)
    tcomps.video_latent_channels = jcomps.video_latent_channels = 8  # the tiny model's channel count
    tv, ta = th.denoise_audio_video(
        out_shape, [VideoConditionByLatentIndex(latent=torch.from_numpy(cond), frame_idx=0, strength=1.0)],
        tcomp.GaussianNoiser(seed=0), sigmas, tcomp.EulerDiffusionStep(), th.euler_denoising_loop, tcomps,
        torch.float32, noise_scale=0.0, initial_video_latent=torch.from_numpy(v0),
        initial_audio_latent=torch.from_numpy(a0),
        denoise_fn=th.simple_denoising_func(torch.ones(1, 2, 4), torch.ones(1, 2, 4), fake))
    names = ("latent", "denoise_mask", "positions")

    @jax.jit  # one dispatch: JAX's op-by-op path compiles each op on first use
    def jdenoise(cond, v0, a0):
        states = jh.denoise_audio_video(
            jtypes.VideoPixelShape(*out_shape), [JL(latent=cond, frame_idx=0, strength=1.0)],
            jcomp.GaussianNoiser(seed=0), sigmas, jcomp.EulerDiffusionStep(), jh.euler_denoising_loop, jcomps,
            jnp.float32, noise_scale=0.0, initial_video_latent=v0, initial_audio_latent=a0,
            denoise_fn=jh.simple_denoising_func(jnp.ones((1, 2, 4)), jnp.ones((1, 2, 4)), fake))
        return [tuple(getattr(st, name) for name in names) for st in states]

    jv, ja = jdenoise(jnp.asarray(cond), jnp.asarray(v0), jnp.asarray(a0))
    assert tv.latent.shape == (1, 8, 2, 2, 2) and ta.latent.shape == a_shape.to_shape()
    for got, ref in ((tv, jv), (ta, ja)):
        for name, r in zip(names, ref):
            _elem(getattr(got, name), r)


def test_denoise_audio_video_defaults_to_the_card(rng):
    """With no device given (``PipelineComponents(dtype)``), the composed
    denoise builds its states on the card, or raises naming device='cpu'
    where there is none; the same holds for the noised-state helpers."""
    from mlx_video_tpu_torch.ltx_pipelines.utils.types import PipelineComponents

    out_shape = ttypes.VideoPixelShape(batch=1, frames=9, height=64, width=64, fps=24.0)
    v0 = torch.from_numpy(rng.normal(size=(1, 8, 2, 2, 2)).astype(np.float32))
    a0 = torch.from_numpy(rng.normal(size=ttypes.AudioLatentShape.from_video_pixel_shape(out_shape).to_shape())
                          .astype(np.float32))
    comps = PipelineComponents(dtype=torch.float32)
    comps.video_latent_channels = 8
    assert comps.device is None

    def fake(video=None, audio=None, perturbations=None):
        return video.latent * 0.5, audio.latent * 0.5

    runs = (
        lambda: th.denoise_audio_video(
            out_shape, [], tcomp.GaussianNoiser(seed=0), np.array([1.0, 0.0], np.float32), tcomp.EulerDiffusionStep(),
            th.euler_denoising_loop, comps, torch.float32, noise_scale=0.0, initial_video_latent=v0,
            initial_audio_latent=a0, denoise_fn=th.simple_denoising_func(None, None, fake)),
        lambda: (th.noise_video_state(out_shape, tcomp.GaussianNoiser(seed=0), [], comps, torch.float32)[0],
                 th.noise_audio_state(out_shape, tcomp.GaussianNoiser(seed=0), [], comps, torch.float32)[0]),
    )
    for run in runs:
        if torch.cuda.is_available():
            assert all(state.latent.device.type == "cuda" for state in run())
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                run()


# the 2-layer AudioVideo DiT of tests/test_torch_port_audio.py: audio tokens
# C * M = 8 * 16 = 128 wide at the pipeline's latent geometry
AV_CFG = dataclasses.replace(tiny_test_config(LTXModelType.AudioVideo, rope_type=LTXRopeType.SPLIT),
                             audio_in_channels=128, audio_out_channels=128)


@pytest.mark.parametrize("guided", ["simple", "cfg"])
def test_denoise_audio_video_on_a_real_dit_matches_jax(guided, rng):
    """The composed joint AV denoise, X0Model(LTXModel(config, dit)) over a
    real 2-layer AudioVideo DiT in fp32 (CFG 3.0 through
    guider_denoising_func, or simple_denoising_func), on JAX's initial
    latents: >= 35 dB per latent frame, video and audio, and max |d| <= 1e-5
    of the largest value (both fp32: it reads 1.7e-7 simple, 4.6e-7 CFG;
    a loop rounded to bf16 misses it)."""
    from ltx_core.model.transformer import LTXModel as JLTXModel, X0Model as JX0Model
    from ltx_pipelines.utils.types import PipelineComponents as JComponents
    from mlx_video_tpu_torch.ltx_core.model.transformer import LTXModel, X0Model
    from mlx_video_tpu_torch.ltx_pipelines.utils.types import PipelineComponents

    tcfg = tconfig.LTXModelConfig.from_dict(AV_CFG.to_dict())
    dit = tm.init_ltx_params(tcfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if "scale_shift_table" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    jx0 = JX0Model(JLTXModel(AV_CFG, jax.tree.map(jnp.asarray, jax_bridge.module_to_jax_tree(dit))))
    jforward = jax.jit(lambda video, audio: jx0(video=video, audio=audio))

    def jtransformer(video=None, audio=None, perturbations=None):
        # JAX's X0Model raises on ``perturbations`` (the reference defect)
        return jforward(video, audio)

    out_shape = ttypes.VideoPixelShape(batch=1, frames=9, height=64, width=64, fps=24.0)
    v0 = rng.normal(size=(1, AV_CFG.in_channels, 2, 2, 2)).astype(np.float32)
    a0 = rng.normal(size=ttypes.AudioLatentShape.from_video_pixel_shape(out_shape).to_shape()).astype(np.float32)
    ctx = {k: rng.normal(size=(1, 5 if k[0] == "v" else 7, 48)).astype(np.float32) for k in ("vp", "vn", "ap", "an")}
    sigmas = np.array([1.0, 0.725, 0.421875, 0.0], dtype=np.float32)
    tcomps, jcomps = PipelineComponents(dtype=torch.float32, device="cpu"), JComponents(dtype=jnp.float32)
    tcomps.video_latent_channels = jcomps.video_latent_channels = AV_CFG.in_channels
    tx0 = X0Model(LTXModel(tcfg, dit))
    t, j = {k: torch.from_numpy(v) for k, v in ctx.items()}, {k: jnp.asarray(v) for k, v in ctx.items()}
    if guided == "cfg":
        tfn = th.guider_denoising_func(tcomp.CFGGuider(3.0), t["vp"], t["vn"], t["ap"], t["an"], tx0)
        jfn = jh.guider_denoising_func(jcomp.CFGGuider(3.0), j["vp"], j["vn"], j["ap"], j["an"], jtransformer)
    else:
        tfn = th.simple_denoising_func(t["vp"], t["ap"], tx0)
        jfn = jh.simple_denoising_func(j["vp"], j["ap"], jtransformer)
    common = dict(conditionings=[], sigmas=sigmas, noise_scale=0.0)
    tv, ta = th.denoise_audio_video(out_shape, noiser=tcomp.GaussianNoiser(seed=0), stepper=tcomp.EulerDiffusionStep(),
                                    denoising_loop_fn=th.euler_denoising_loop, components=tcomps, dtype=torch.float32,
                                    initial_video_latent=torch.from_numpy(v0),
                                    initial_audio_latent=torch.from_numpy(a0), denoise_fn=tfn, **common)
    jv, ja = jh.denoise_audio_video(jtypes.VideoPixelShape(*out_shape), noiser=jcomp.GaussianNoiser(seed=0),
                                    stepper=jcomp.EulerDiffusionStep(), denoising_loop_fn=jh.euler_denoising_loop,
                                    components=jcomps, dtype=jnp.float32, initial_video_latent=jnp.asarray(v0),
                                    initial_audio_latent=jnp.asarray(a0), denoise_fn=jfn, **common)
    assert tv.latent.shape == v0.shape and ta.latent.shape == a0.shape
    assert torch.isfinite(tv.latent).all() and torch.isfinite(ta.latent).all()
    assert _min_frame_psnr(tv.latent, jv.latent) >= 35.0
    assert _min_frame_psnr(ta.latent, ja.latent) >= 35.0
    for got, ref in ((tv.latent, jv.latent), (ta.latent, ja.latent)):
        got, ref = _np(got), _np(ref)
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert float((tv.latent - torch.from_numpy(v0)).abs().max()) > 0.1  # the DiT moved the latents


def test_audio_shape_from_video_pixel_shape():
    # 16000 / 160 / 4 = 25 latents/sec; 48 frames @ 24 fps = 2 s -> 50
    px = ttypes.VideoPixelShape(batch=1, frames=48, height=64, width=64, fps=24.0)
    assert ttypes.AudioLatentShape.from_video_pixel_shape(px) == ttypes.AudioLatentShape(1, 8, 50, 16)
    assert tuple(ttypes.AudioLatentShape.from_video_pixel_shape(px)) == \
        tuple(jtypes.AudioLatentShape.from_video_pixel_shape(jtypes.VideoPixelShape(*px)))


def test_clean_response_matches_jax():
    cases = ["“hello”", "123 ... drop leading: Words", "<start_of_turn>model\nA cat", "—–",
             "  <eos>‘quoted’ —dash space′ −minus<end_of_turn>", "", "42"]
    for text in cases:
        assert th.clean_response(text) == jh.clean_response(text), text
    assert th.clean_response("“hello”") == 'hello"' and th.clean_response("—–") == "--"


def test_helpers_name_parity():
    """Name for name: every public function of the JAX helpers module
    exists here."""
    import inspect

    names = [n for n, f in inspect.getmembers(jh, inspect.isfunction)
             if not n.startswith("_") and f.__module__ == jh.__name__]
    assert len(names) >= 19
    for name in names:
        assert callable(getattr(th, name)), name


def test_generate_enhanced_prompt_matches_jax(tmp_path):
    calls = {}

    class StubEncoder:
        def __init__(self, key):
            self.key = key

        def enhance_t2v(self, prompt, seed=None):
            calls[(self.key, "t2v")] = (prompt, seed)
            return "<start_of_turn>model\n“Enhanced” text"

        def enhance_i2v(self, prompt, image, seed=None):
            calls[(self.key, "i2v")] = (prompt, np.asarray(image).shape, seed)
            return "... 1: An image prompt"

    img = tmp_path / "cond.png"
    Image.fromarray(np.zeros((100, 200, 3), dtype=np.uint8)).save(img)
    for key, mod in (("t", th), ("j", jh)):
        assert mod.generate_enhanced_prompt(StubEncoder(key), "a cat", seed=7) == 'Enhanced" text'
        assert mod.generate_enhanced_prompt(StubEncoder(key), "a dog", image_path=str(img),
                                            image_long_side=64) == "An image prompt"
    assert calls[("t", "t2v")] == calls[("j", "t2v")] == ("a cat", 7)
    assert calls[("t", "i2v")] == calls[("j", "i2v")] == ("a dog", (32, 64, 3), 42)


def test_distilled_main_runs_the_generate_cli_on_the_cpu(monkeypatch, tmp_path):
    """The reference's per-pipeline entry end to end on a tiny bundle:
    ``ltx_pipelines.distilled.main()`` with ``sys.argv`` set, run_cli adds
    ``--pipeline distilled``, and the port's generate CLI writes the mp4 and
    the phase report (chip_smoke.py phase 20 (b) on the card)."""
    import json

    from mlx_video_tpu.io.safetensors import save_safetensors
    from mlx_video_tpu_torch import loading
    from mlx_video_tpu_torch.ltx_pipelines import distilled
    from test_torch_port_cli import _tiny_bundle

    calls = []
    monkeypatch.setattr(loading, "load_model_bundle", lambda *a, **kw: calls.append(kw) or _tiny_bundle())
    emb = tmp_path / "emb.safetensors"
    save_safetensors(emb, {"video_prompt_embeds": np.random.default_rng(0).standard_normal((8, 48)).astype(np.float32)})
    out, report = tmp_path / "out.mp4", tmp_path / "phases.json"
    monkeypatch.setattr(sys, "argv", [
        "ltx_pipelines.distilled", "--prompt", "a tiny cat", "--checkpoint-path", str(tmp_path), "--embeddings",
        str(emb), "--height", "64", "--width", "64", "--num-frames", "9", "--stage1-steps", "1", "--stage2-steps", "1",
        "--tiling", "none", "--output-path", str(out), "--profile-json-path", str(report), "--device", "cpu"])
    distilled.main()
    assert sys.argv[-2:] == ["--pipeline", "distilled"]
    assert calls and calls[0]["device"] == torch.device("cpu") and out.stat().st_size > 0
    assert {"stage1_denoise", "upsample", "stage2_denoise", "vae_decode"} <= set(json.loads(report.read_text())["phases"])
