"""The port's generate CLI (``python -m mlx_video_tpu_torch.generate``) on the CPU.

As tests/test_cli_generate.py does for the JAX CLI, ``load_model_bundle`` is
patched to return a tiny in-memory bundle (the real loader builds the 19B
geometry; its parts are tested in tests/test_torch_port_loading.py), and
``main`` runs the rest of the user's path with ``--device cpu``: flags ->
quantization -> embeddings file -> generate_video -> mp4 and phase JSON.
"""

import json

import numpy as np
import pytest
import torch

from mlx_video_tpu.io.safetensors import save_safetensors
from mlx_video_tpu_torch import loading
from mlx_video_tpu_torch.cli import generate as cli
from mlx_video_tpu_torch.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu_torch.models.ltx.model import init_ltx_params
from mlx_video_tpu_torch.models.ltx.upsampler import init_latent_upsampler
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, init_video_decoder
from mlx_video_tpu_torch.ops.linear import QuantLinear
from mlx_video_tpu_torch.pipelines.generate import ModelBundle


def _tiny_bundle() -> ModelBundle:
    cfg = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)
    g = torch.Generator().manual_seed(0)
    dec_cfg = DecoderConfig(in_channels=16, base_channels=32, num_layers_per_block=1)
    return ModelBundle(init_ltx_params(cfg, g, device="cpu", dtype=torch.float32), cfg,
                       init_video_decoder(g, dec_cfg, device="cpu"), dec_cfg,
                       init_latent_upsampler(g, 16, 32, 1, device="cpu"))


@pytest.fixture
def emb_file(tmp_path):
    path = tmp_path / "emb.safetensors"
    save_safetensors(path, {"video_prompt_embeds": np.random.default_rng(0).standard_normal((8, 48)).astype(np.float32)})
    return path


def _run_main(monkeypatch, tmp_path, emb_file, bundle, extra=()):
    calls = []

    def fake_load(*args, **kwargs):
        calls.append(kwargs)
        return bundle

    monkeypatch.setattr(loading, "load_model_bundle", fake_load)
    out = tmp_path / "out.mp4"
    cli.main([
        "--prompt", "a tiny cat", "--checkpoint-path", str(tmp_path), "--embeddings", str(emb_file),
        "--height", "64", "--width", "64", "--num-frames", "9", "--stage1-steps", "1", "--stage2-steps", "1",
        "--tiling", "none", "--output-path", str(out), "--profile-json-path", str(tmp_path / "phases.json"),
        "--device", "cpu", *extra,
    ])
    assert calls and calls[0]["device"] == torch.device("cpu")
    return out


@pytest.mark.parametrize("extra", [(), ("--video-encoder", "cv2")])
def test_main_writes_mp4_and_phase_json(monkeypatch, tmp_path, emb_file, extra):
    out = _run_main(monkeypatch, tmp_path, emb_file, _tiny_bundle(), extra)
    assert out.stat().st_size > 0
    report = json.loads((tmp_path / "phases.json").read_text())
    assert {"load", "stage1_denoise", "upsample", "stage2_denoise", "vae_decode"} <= set(report["phases"])
    assert report["total"] == pytest.approx(sum(report["phases"].values()))


def test_main_quantizes_to_4_bits_and_runs(monkeypatch, tmp_path, emb_file):
    bundle = _tiny_bundle()
    out = _run_main(monkeypatch, tmp_path, emb_file, bundle, ("--quantization", "4"))
    assert out.stat().st_size > 0
    quant = [m for m in bundle.transformer.modules() if isinstance(m, QuantLinear)]
    assert len(quant) == 10 * bundle.transformer_config.num_layers and {m.bits for m in quant} == {4}


def test_main_latents_only_writes_no_video(monkeypatch, tmp_path, emb_file):
    out = _run_main(monkeypatch, tmp_path, emb_file, _tiny_bundle(), ("--latents-only",))
    assert not out.exists()
    assert "vae_decode" not in json.loads((tmp_path / "phases.json").read_text())["phases"]


@pytest.mark.parametrize("flags, named", [
    (["--lora", "x.safetensors"], "--lora"),
    (["--w4a8"], "--w4a8"),
    (["--w8a8"], "--w8a8"),
    (["--mesh", "auto"], "--mesh"),
    (["--image", "a.png"], "--image"),
    (["--audio"], "--audio"),
    (["--pipeline", "dev"], "--pipeline dev"),
    (["--teacache-threshold", "0.1"], "--teacache-threshold"),
    (["--enhance-prompt"], "--enhance-prompt"),
    (["--skip-audio"], "--skip-audio"),
    (["--temperature", "0.2"], "--temperature"),
    (["--image-strength", "0.5"], "--image-strength"),
])
def test_unported_flags_exit_with_their_names(emb_file, flags, named):
    with pytest.raises(SystemExit, match=named):
        cli.main(["--prompt", "p", "--embeddings", str(emb_file), "--device", "cpu", *flags])


def test_prompt_without_embeddings_exits():
    with pytest.raises(SystemExit, match="--embeddings"):
        cli.main(["--prompt", "p", "--device", "cpu"])


def test_cuda_device_without_cuda_exits(emb_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(["--prompt", "p", "--embeddings", str(emb_file)])


def test_parser_keeps_the_jax_flag_names():
    from mlx_video_tpu.cli.generate import build_parser as jax_parser

    ours = {a for action in cli.build_parser()._actions for a in action.option_strings}
    theirs = {a for action in jax_parser()._actions for a in action.option_strings}
    assert ours - theirs == {"--device"} and theirs <= ours
    assert cli._PORTED - {"device"} <= {action.dest for action in jax_parser()._actions}


@pytest.mark.parametrize("key, shape", [("video", (1, 8, 48)), ("video_prompt_embeds", (8, 48))])
def test_load_embeddings(tmp_path, key, shape):
    path = tmp_path / "e.safetensors"
    arr = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    save_safetensors(path, {key: arr, "audio": np.zeros((8, 4), np.float32)})
    text = cli.load_embeddings(path)
    assert text.video_embeddings.shape == (1, 8, 48)
    np.testing.assert_array_equal(text.video_embeddings.numpy().reshape(shape), arr)
    save_safetensors(path, {"audio": arr})
    with pytest.raises(ValueError, match="video"):
        cli.load_embeddings(path)
