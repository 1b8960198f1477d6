"""The port's own copies of the JAX package's framework-free modules against
the originals, one parametrised test per copied module, on the same inputs.

The port imports nothing of mlx_video_tpu, so it keeps copies of: the model
configuration, the sigma schedules, the position grids, the numpy part of the
VAE tiling, the mp4 writer's frame conversion, the image and video loading, the generate,
train, serve and enhance CLIs' parsers and ``slugify``, the enhancement system prompts, the hub's ``get_model_path``, the
dev pipeline's default negative prompt, the loader's ``bits_hint_for`` and
``read_quantization_metadata``, and the trainer's progress line, config
display and video IO (trainer/aux.py); the precompute helpers and the
log-mel processor are held in tests/test_torch_port_precompute.py; the
sharding rules and ``factor_devices`` of parallel/. Every
comparison here is exact: the copies are the same code.
"""

import argparse
import dataclasses

import numpy as np
import pytest

from mlx_video_tpu import config as jconfig
from mlx_video_tpu.cli import enhance as jenhance_cli
from mlx_video_tpu.cli import generate as jgen_cli
from mlx_video_tpu.cli import serve as jserve_cli
from mlx_video_tpu.cli import train as jtrain_cli
from mlx_video_tpu.io import media as jmedia
from mlx_video_tpu.models.ltx.video_vae import tiling as jtiling
from mlx_video_tpu.pipelines import positions as jpos
from mlx_video_tpu.pipelines import schedulers as jsched
from mlx_video_tpu.trainer import config as jtrain_config
from mlx_video_tpu.utils import hub as jhub
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch.cli import enhance as tenhance_cli
from mlx_video_tpu_torch.cli import generate as tgen_cli
from mlx_video_tpu_torch.cli import serve as tserve_cli
from mlx_video_tpu_torch.cli import train as ttrain_cli
from mlx_video_tpu_torch.io import media as tmedia
from mlx_video_tpu_torch.models.ltx.video_vae import tiling as ttiling
from mlx_video_tpu_torch.pipelines import positions as tpos
from mlx_video_tpu_torch.pipelines import schedulers as tsched
from mlx_video_tpu_torch.trainer import config as ttrain_config
from mlx_video_tpu_torch.utils import hub as thub


def _plain(x):
    """Dataclasses, enums and arrays as comparable plain values."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if hasattr(x, "value") and hasattr(x, "name") and not isinstance(x, np.ndarray):
        return ("enum", x.name, x.value)
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, slice):
        return ("slice", x.start, x.stop, x.step)
    return x


@pytest.mark.parametrize("case", [
    ("farthest", 1), ("farthest", 3), ("farthest", 5), ("farthest", 8), ("uniform", 4), ("uniform", 7),
    ("refine", 1), ("refine", 2), ("ltx2", 30), ("ltx2", 8),
])
def test_schedulers_copy(case):
    method, steps = case
    for mod in (jsched, tsched):
        assert mod.STAGE_1_SIGMAS == jsched.STAGE_1_SIGMAS and mod.STAGE_2_SIGMAS == jsched.STAGE_2_SIGMAS
    if method == "refine":
        assert tsched.subsample_refinement_sigmas(tsched.STAGE_2_SIGMAS, steps) == \
            jsched.subsample_refinement_sigmas(jsched.STAGE_2_SIGMAS, steps)
    elif method == "ltx2":
        for tokens in (None, 1280, 3456, 9000):
            np.testing.assert_array_equal(tsched.ltx2_scheduler(steps, tokens), jsched.ltx2_scheduler(steps, tokens))
    else:
        assert tsched.subsample_sigmas(tsched.STAGE_1_SIGMAS, steps, method) == \
            jsched.subsample_sigmas(jsched.STAGE_1_SIGMAS, steps, method)
    assert (tsched.BASE_SHIFT_ANCHOR, tsched.MAX_SHIFT_ANCHOR) == (jsched.BASE_SHIFT_ANCHOR, jsched.MAX_SHIFT_ANCHOR)


@pytest.mark.parametrize("b, f, h, w, fps, causal", [
    (1, 5, 8, 8, 24.0, True), (2, 9, 16, 24, 25.0, True), (1, 1, 3, 7, 30.0, False),
])
def test_positions_copy(b, f, h, w, fps, causal):
    np.testing.assert_array_equal(
        tpos.create_position_grid(b, f, h, w, fps=fps, causal_fix=causal),
        jpos.create_position_grid(b, f, h, w, fps=fps, causal_fix=causal),
    )
    np.testing.assert_array_equal(tpos.create_audio_position_grid(b, 3 * f), jpos.create_audio_position_grid(b, 3 * f))
    assert tpos.compute_audio_frames(8 * f + 1, fps) == jpos.compute_audio_frames(8 * f + 1, fps)


@pytest.mark.parametrize("case", [
    "masks", "intervals", "presets", "tile_shapes", "decode",
])
def test_tiling_copy(case):
    if case == "masks":
        for args in [(10, 3, 2, False), (10, 3, 2, True), (4, 0, 0, False), (5, 9, 9, True), (17, 8, 8, False)]:
            np.testing.assert_array_equal(ttiling.compute_trapezoidal_mask_1d(*args),
                                          jtiling.compute_trapezoidal_mask_1d(*args))
        for args in [(0, 5, 2, 1, 8), (3, 9, 0, 2, 8), (0, 16, 4, 4, 32)]:
            assert _plain(ttiling.map_temporal_slice(*args)) == _plain(jtiling.map_temporal_slice(*args))
            assert _plain(ttiling.map_spatial_slice(*args)) == _plain(jtiling.map_spatial_slice(*args))
    elif case == "intervals":
        for args in [(16, 4, 40), (8, 2, 8), (16, 4, 100), (5, 1, 33)]:
            assert _plain(ttiling.split_in_spatial(*args)) == _plain(jtiling.split_in_spatial(*args))
            assert _plain(ttiling.split_in_temporal(*args)) == _plain(jtiling.split_in_temporal(*args))
    elif case == "presets":
        for name in ("default", "aggressive", "conservative", "spatial_only", "temporal_only"):
            assert _plain(getattr(ttiling.TilingConfig, name)()) == _plain(getattr(jtiling.TilingConfig, name)())
        for h, w, f in [(512, 512, 33), (768, 1024, 121), (1536, 1536, 257)]:
            assert _plain(ttiling.TilingConfig.auto(h, w, f)) == _plain(jtiling.TilingConfig.auto(h, w, f))
    elif case == "tile_shapes":
        for shape in [(1, 16, 5, 8, 8), (1, 16, 17, 24, 40)]:
            assert ttiling.tile_latent_shapes(shape, ttiling.TilingConfig.default()) == \
                jtiling.tile_latent_shapes(shape, jtiling.TilingConfig.default())
    else:
        rng = np.random.default_rng(0)
        lat = rng.normal(size=(1, 4, 5, 6, 6)).astype(np.float32)

        def decode(tile):  # a stand-in decoder: causal nearest upsample, 3 channels
            up = tile[:, :3].repeat(32, axis=3).repeat(32, axis=4)
            return np.concatenate([up[:, :, :1], up[:, :, 1:].repeat(8, axis=2)], axis=2)

        got = ttiling.decode_with_tiling(decode, lat, ttiling.TilingConfig(
            ttiling.SpatialTilingConfig(64, 32), ttiling.TemporalTilingConfig(16, 8)))
        ref = jtiling.decode_with_tiling(decode, lat, jtiling.TilingConfig(
            jtiling.SpatialTilingConfig(64, 32), jtiling.TemporalTilingConfig(16, 8)))
        assert got.shape == (1, 3, 33, 192, 192)
        np.testing.assert_array_equal(got, ref)


def _flags(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("cli", ["generate", "train", "serve", "enhance"])
def test_parsers_copy(cli):
    """Each CLI's flags as the JAX parser's, plus --device. The server's
    output directory defaults to None (the temporary directory's), where the
    JAX one names /tmp; its refused flag stays, to be refused by name."""
    tmod, jmod = {"generate": (tgen_cli, jgen_cli), "train": (ttrain_cli, jtrain_cli),
                  "serve": (tserve_cli, jserve_cli), "enhance": (tenhance_cli, jenhance_cli)}[cli]
    if cli == "generate":
        for text in ("A cat, on a MAT!", "", "  --x--  ", "é" * 100):
            assert tmod.slugify(text) == jmod.slugify(text)
    ref = _flags(jmod.build_parser())
    if cli == "serve":
        assert ref["output_dir"][1] == "/tmp/mlx_video_tpu_serve"
        ref["output_dir"] = ref["output_dir"][:1] + (None,) + ref["output_dir"][2:]
        assert set(tserve_cli._REFUSED) == {"aux_park"} and set(tserve_cli._REFUSED) <= set(ref)
    assert _flags(tmod.base_parser()) == ref
    ported = _flags(tmod.build_parser())
    assert ported.pop("device") == (("--device",), "cuda", None, None, "_StoreAction")
    if cli == "train":  # the YAML-only switch as a flag (no PyYAML needed)
        assert ported.pop("enable_gradient_checkpointing")[0] == ("--enable-gradient-checkpointing",)
    assert ported == ref


def test_enhancement_system_prompts_copy():
    from mlx_video_tpu.models.ltx import text_encoder as jte
    from mlx_video_tpu_torch.models.ltx import text_encoder as tte

    names = sorted(p.name for p in jte.PROMPTS_DIR.glob("*.txt"))
    assert names == sorted(p.name for p in tte.PROMPTS_DIR.glob("*.txt")) and len(names) == 3
    for name in names:
        assert (tte.PROMPTS_DIR / name).read_bytes() == (jte.PROMPTS_DIR / name).read_bytes()


@pytest.mark.parametrize("case", ["default", "tiny_split", "tiny_audio", "round_trip", "training"])
def test_config_copy(case):
    if case == "default":
        assert _plain(tconfig.LTXModelConfig()) == _plain(jconfig.LTXModelConfig())
        assert tconfig.LTXModelConfig().to_dict() == jconfig.LTXModelConfig().to_dict()
    elif case == "tiny_split":
        t = tconfig.tiny_test_config(tconfig.LTXModelType.VideoOnly, rope_type=tconfig.LTXRopeType.SPLIT)
        j = jconfig.tiny_test_config(jconfig.LTXModelType.VideoOnly, rope_type=jconfig.LTXRopeType.SPLIT)
        assert t.to_dict() == j.to_dict() and _plain(t.get_video_config()) == _plain(j.get_video_config())
    elif case == "tiny_audio":
        t, j = tconfig.tiny_test_config(num_layers=3), jconfig.tiny_test_config(num_layers=3)
        assert t.to_dict() == j.to_dict() and _plain(t.get_audio_config()) == _plain(j.get_audio_config())
        assert t.inner_dim == j.inner_dim and t.audio_inner_dim == j.audio_inner_dim
    elif case == "round_trip":
        d = jconfig.LTXModelConfig(rope_type=jconfig.LTXRopeType.SPLIT, num_layers=7).to_dict()
        assert tconfig.LTXModelConfig.from_dict(d).to_dict() == jconfig.LTXModelConfig.from_dict(d).to_dict()
    else:
        assert _plain(ttrain_config.TrainingConfig()) == _plain(jtrain_config.TrainingConfig())
        assert _plain(ttrain_config.TrainingConfig(lr="2e-4", steps="7")) == \
            _plain(jtrain_config.TrainingConfig(lr="2e-4", steps="7"))
        assert ttrain_config._normalize_target_modules(["to_out.0", "ff.net.2"]) == \
            jtrain_config._normalize_target_modules(["to_out.0", "ff.net.2"])


@pytest.mark.parametrize("shape", [(1, 3, 4, 6, 5), (3, 2, 7, 9)])
def test_media_copy(shape):
    video = np.random.default_rng(0).uniform(-1.3, 1.3, size=shape).astype(np.float32)
    np.testing.assert_array_equal(tmedia.frames_to_uint8(video), jmedia.frames_to_uint8(video))


@pytest.mark.parametrize("size, target", [
    ((64, 96), (64, 96)), ((64, 96), (32, 64)), ((70, 100), (None, None)), ((70, 100), (64, None)),
    ((70, 100), (None, 64)),
])
def test_image_copy(tmp_path, size, target):
    """load_image (exact size, LANCZOS resize, rounding down to /32) and
    prepare_image_for_encoding (with and without its resize)."""
    from PIL import Image

    path = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(1).integers(0, 256, size=(*size, 3), dtype=np.uint8)).save(path)
    got, ref = tmedia.load_image(path, *target), jmedia.load_image(path, *target)
    np.testing.assert_array_equal(got, ref)
    for h, w in ((got.shape[0], got.shape[1]), (32, 64)):
        np.testing.assert_array_equal(tmedia.prepare_image_for_encoding(got, h, w),
                                      jmedia.prepare_image_for_encoding(ref, h, w))


@pytest.mark.parametrize("target, cap", [((64, 96), None), ((32, 48), 5), ((None, None), 3), ((64, 96), 20)])
def test_video_copy(tmp_path, target, cap):
    """load_video (cv2 decode, INTER_AREA resize, a frame cap) and
    prepare_video_for_encoding (with and without its resize), on an mp4
    written with cv2."""
    import cv2

    path = tmp_path / "clip.mp4"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 24.0, (96, 64))
    rng = np.random.default_rng(2)
    for _ in range(9):
        writer.write(rng.integers(0, 256, size=(64, 96, 3), dtype=np.uint8))
    writer.release()
    got, ref = tmedia.load_video(path, *target, frame_cap=cap), jmedia.load_video(path, *target, frame_cap=cap)
    assert got.shape[0] == min(9, cap or 9)
    np.testing.assert_array_equal(got, ref)
    for h, w in ((got.shape[1], got.shape[2]), (32, 64)):
        np.testing.assert_array_equal(tmedia.prepare_video_for_encoding(got, h, w),
                                      jmedia.prepare_video_for_encoding(ref, h, w))
    for mod in (tmedia, jmedia):
        with pytest.raises(ValueError, match="Unable to open video"):
            mod.load_video(tmp_path / "missing.mp4")


@pytest.mark.parametrize("layout", ["unified", "single_file", "subsystems", "incomplete"])
def test_hub_copy(tmp_path, layout):
    files = {
        "unified": ["model.safetensors"],
        "single_file": ["ltx-2-19b-distilled.safetensors"],
        "subsystems": jhub.REQUIRED_MODEL_FILES,
        "incomplete": jhub.REQUIRED_MODEL_FILES[:2],
    }[layout]
    for rel in files:
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    assert thub.has_required_files(tmp_path) == jhub.has_required_files(tmp_path)
    assert thub.get_model_path(str(tmp_path)) == jhub.get_model_path(str(tmp_path)) == tmp_path
    assert thub.MODEL_REPO_ALIASES == jhub.MODEL_REPO_ALIASES


def test_prompts_copy():
    from mlx_video_tpu.pipelines import prompts as jprompts
    from mlx_video_tpu_torch.pipelines import prompts as tprompts

    assert tprompts.DEFAULT_NEGATIVE_PROMPT == jprompts.DEFAULT_NEGATIVE_PROMPT


@pytest.mark.parametrize("repo", ["AITRADER/ltx2-distilled-4bit-mlx", "x-q8", "org/int8-model", "Lightricks/LTX-2"])
def test_quantize_models_bits_helpers_copy(tmp_path, repo):
    """bits_hint_for and read_quantization_metadata (loading.py and
    trainer/aux.py in the JAX package), which pick W4A8's stored width."""
    import json

    from mlx_video_tpu import loading as jloading
    from mlx_video_tpu.trainer import aux as jaux
    from mlx_video_tpu_torch import loading as tloading

    assert tloading.bits_hint_for(repo) == jloading.bits_hint_for(repo)
    assert tloading.read_quantization_metadata(tmp_path) == jaux.read_quantization_metadata(tmp_path) is None
    (tmp_path / "quantization.json").write_text(json.dumps({"bits": 8, "repo": repo}))
    sub = tmp_path / "weights"
    assert tloading.read_quantization_metadata(sub) == jaux.read_quantization_metadata(sub) == {"bits": 8, "repo": repo}


@pytest.mark.parametrize("case", ["stereo", "mono_1d", "clipped"])
def test_save_wav_copy(tmp_path, case):
    """The WAV writer (audio_vae/processing.py): the same file bytes."""
    from mlx_video_tpu.models.ltx.audio_vae import processing as jproc
    from mlx_video_tpu_torch.models.ltx.audio_vae import processing as tproc

    rng = np.random.default_rng(3)
    wav = {"stereo": rng.uniform(-1, 1, (2, 480)), "mono_1d": rng.uniform(-1, 1, 300),
           "clipped": 3.0 * rng.standard_normal((2, 200))}[case].astype(np.float32)
    jproc.save_wav(str(tmp_path / "j.wav"), wav, 16000)
    tproc.save_wav(str(tmp_path / "t.wav"), wav, 16000)
    assert (tmp_path / "j.wav").read_bytes() == (tmp_path / "t.wav").read_bytes()


@pytest.mark.parametrize("branch", ["no_ffmpeg", "command", "filter_off", "ffmpeg"])
def test_mux_audio_copy(tmp_path, monkeypatch, branch):
    """mux_audio: without ffmpeg both return False and run nothing; with it
    (stood in for) both run the same command and return its success; with a
    real ffmpeg both write a muxed mp4."""
    import shutil
    import types

    if branch == "ffmpeg":
        if shutil.which("ffmpeg") is None:
            pytest.skip("no ffmpeg on this machine")
        from mlx_video_tpu.models.ltx.audio_vae.processing import save_wav

        tmedia.write_video(tmp_path / "v.mp4", np.zeros((1, 3, 9, 32, 32), np.float32), 24.0)
        save_wav(str(tmp_path / "a.wav"), np.zeros((2, 4000), np.float32))
        for mod, out in ((jmedia, "j.mp4"), (tmedia, "t.mp4")):
            assert mod.mux_audio(tmp_path / "v.mp4", tmp_path / "a.wav", tmp_path / out)
            assert (tmp_path / out).stat().st_size > 0
        return
    ran = []  # both modules call the one shutil.which and subprocess.run
    monkeypatch.setattr(tmedia.shutil, "which", lambda n: None if branch == "no_ffmpeg" else "/bin/ffmpeg")
    monkeypatch.setattr(tmedia.subprocess, "run",
                        lambda cmd, **kw: ran.append(cmd) or types.SimpleNamespace(returncode=(len(ran) - 1) // 2))
    kw = dict(audio_filter="off" if branch == "filter_off" else "volume=2", audio_bitrate="96k",
              audio_sample_rate=16000)
    results = [[mod.mux_audio("v.mp4", "a.wav", "o.mp4", **kw) for mod in (jmedia, tmedia)] for _ in range(2)]
    if branch == "no_ffmpeg":
        assert ran == [] and results == [[False, False]] * 2
    else:  # the stand-in fails its second pair of runs
        assert results == [[True, True], [False, False]] and ran[0] == ran[1] == ran[2] == ran[3]
        assert ("-af" in ran[0]) == (branch == "command")


@pytest.mark.parametrize("part", ["print_config", "progress", "save_and_read_video"])
def test_trainer_aux_copy(part, tmp_path, capsys):
    """trainer/aux.py: the config display and the progress line print the
    same text; save_video then read_video give the same frames."""
    from mlx_video_tpu.trainer import aux as jaux
    from mlx_video_tpu_torch.trainer import aux as taux

    outs = []
    for mod, cfg_mod in ((jaux, jtrain_config), (taux, ttrain_config)):
        if part == "print_config":
            mod.print_config(cfg_mod.TrainingConfig(steps=7, with_audio=True, lora_rank=16))
            outs.append(capsys.readouterr().out)
        elif part == "progress":
            with mod.TrainingProgress(4) as progress:
                progress.update(mod.ProgressStats(step=1, total=4, loss=0.5, step_time=2.0))
            err = capsys.readouterr().err
            outs.append(err.split(" eta=")[0])  # the eta reads the wall clock
        else:
            frames = np.random.default_rng(2).uniform(0, 1, (9, 32, 48, 3)).astype(np.float32)
            path = tmp_path / f"{mod.__name__.split('.')[0]}.mp4"
            mod.save_video(path, frames, fps=24.0)
            outs.append(mod.read_video(path, frame_cap=5))
    if part == "save_and_read_video":
        assert outs[0].shape == (5, 32, 48, 3)
        np.testing.assert_array_equal(outs[1], outs[0])
    else:
        assert outs[0] == outs[1] and outs[0]


@pytest.mark.parametrize("part", ["psnr", "per_frame_psnr", "compare_tensors", "main"])
def test_compare_latents_copy(part, tmp_path, capsys):
    """tools/compare_latents.py: the same numbers and the same printed text
    (``main`` on two files written by the JAX writer, bf16 among them)."""
    import ml_dtypes

    from mlx_video_tpu.io.safetensors import save_safetensors
    from mlx_video_tpu.tools import compare_latents as jcl
    from mlx_video_tpu_torch.tools import compare_latents as tcl

    rng = np.random.default_rng(5)
    a = rng.normal(size=(1, 4, 3, 5, 6)).astype(np.float32)
    b = a + rng.normal(size=a.shape).astype(np.float32) * 0.01
    if part == "psnr":
        for x, y, rng_ in ((a, b, None), (a, b, 2.0), (a, a, None)):
            assert tcl.psnr(x, y, rng_) == jcl.psnr(x, y, rng_)
        return
    if part == "per_frame_psnr":
        np.testing.assert_array_equal(tcl.per_frame_psnr(a, b), jcl.per_frame_psnr(a, b))
        np.testing.assert_array_equal(tcl.per_frame_psnr(a, b, frame_axis=3), jcl.per_frame_psnr(a, b, frame_axis=3))
        return
    tensors_a = {"latents": a, "w": rng.normal(size=(4, 4)).astype(np.float32), "only_a": np.ones(2, np.float32),
                 "shape": np.zeros((2, 3), np.float32), "half": rng.normal(size=(3, 3)).astype(ml_dtypes.bfloat16)}
    tensors_b = {"latents": b, "w": tensors_a["w"] * 1.001, "only_b": np.ones(2, np.float32),
                 "shape": np.zeros((3, 2), np.float32), "half": tensors_a["half"]}
    outs = []
    for mod in (jcl, tcl):
        if part == "compare_tensors":
            worst = mod.compare_tensors({k: np.asarray(v, np.float32) for k, v in tensors_a.items()},
                                        {k: np.asarray(v, np.float32) for k, v in tensors_b.items()})
            outs.append((capsys.readouterr().out, worst))
        else:
            save_safetensors(tmp_path / "a.safetensors", tensors_a)
            save_safetensors(tmp_path / "b.safetensors", tensors_b)
            mod.main([str(tmp_path / "a.safetensors"), str(tmp_path / "b.safetensors"), "--per-frame"])
            outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "only in A" in str(outs[0]) and "SHAPE MISMATCH" in str(outs[0])


@pytest.mark.parametrize("case", [
    ("bilateral_filter", {}), ("bilateral_filter", {"d": 7, "sigma_color": 30, "sigma_space": 20}),
    ("gaussian_blur", {}), ("gaussian_blur", {"kernel_size": 5}), ("unsharp_mask", {"amount": 0.5}),
    ("remove_grid_frequency", {}), ("reduce_grid_artifacts:bilateral", {"strength": 1.0}),
    ("reduce_grid_artifacts:gaussian", {"strength": 0.6}), ("reduce_grid_artifacts:frequency", {"strength": 0.3}),
])
def test_postprocess_copy(case):
    """postprocess.py: each filter on a seeded uint8 frame (a 3-frame video
    for reduce_grid_artifacts) gives the same bytes."""
    from mlx_video_tpu import postprocess as jpost
    from mlx_video_tpu_torch import postprocess as tpost

    name, kw = case
    rng = np.random.default_rng(9)
    frame = rng.integers(0, 256, size=(40, 48, 3), dtype=np.uint8)
    if name.startswith("reduce_grid_artifacts"):
        video = rng.integers(0, 256, size=(3, 32, 40, 3), dtype=np.uint8)
        method = name.split(":")[1]
        got, ref = (mod.reduce_grid_artifacts(video, method=method, **kw) for mod in (tpost, jpost))
    else:
        got, ref = (getattr(mod, name)(frame, **kw) for mod in (tpost, jpost))
    assert got.dtype == ref.dtype == np.uint8 and got.tobytes() == ref.tobytes()
    with pytest.raises(ValueError, match="Unknown method"):
        tpost.reduce_grid_artifacts(frame[None], method="median")


def test_convert_parser_copy(monkeypatch):
    """convert.py's flags as the JAX converter's (whose parser lives inside
    its main), plus --device."""
    from mlx_video_tpu import convert as jconvert
    from mlx_video_tpu_torch import convert as tconvert

    seen = []

    def capture(parser, args=None, namespace=None):
        seen.append(parser)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        jconvert.main([])
    monkeypatch.undo()
    ported = _flags(tconvert.build_parser())
    assert ported.pop("device") == (("--device",), "cuda", None, None, "_StoreAction")
    assert ported == _flags(seen[0])


@pytest.mark.parametrize("part", ["rules", "factor_devices"])
def test_parallel_copy(part):
    """parallel/sharding.py's ``_RULES`` (a spec a tuple where JAX's is a
    ``PartitionSpec``, the same entries) and parallel/mesh.py's
    ``factor_devices``."""
    from mlx_video_tpu.parallel import mesh as jmesh
    from mlx_video_tpu.parallel import sharding as jsharding
    from mlx_video_tpu_torch.parallel import mesh as tmesh
    from mlx_video_tpu_torch.parallel import sharding as tsharding

    if part == "rules":
        assert [(pattern, tuple(spec)) for pattern, spec in jsharding._RULES] == tsharding._RULES
    else:
        for n in range(1, 65):
            assert tmesh.factor_devices(n) == jmesh.factor_devices(n)
