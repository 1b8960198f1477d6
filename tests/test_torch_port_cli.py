"""The port's generate CLI (``python -m mlx_video_tpu_torch.generate``) on the CPU.

As tests/test_cli_generate.py does for the JAX CLI, ``load_model_bundle`` is
patched to return a tiny in-memory bundle (the real loader builds the 19B
geometry; its parts are tested in tests/test_torch_port_loading.py), and
``main`` runs the rest of the user's path with ``--device cpu``: flags ->
quantization (4-bit, W8A8, W4A8) -> embeddings file, or the prompt through a
tiny Gemma-3 text encoder snapshot with its own tokenizer -> generate_video
-> mp4 and phase JSON, for the distilled pipeline and for the dev pipeline
with an image.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from mlx_video_tpu.io.safetensors import save_safetensors
from mlx_video_tpu_torch import loading
from mlx_video_tpu_torch.cli import generate as cli
from mlx_video_tpu_torch.config import LTXModelType, LTXRopeType, VideoVAEConfig, tiny_test_config
from mlx_video_tpu_torch.models.ltx.model import init_ltx_params
from mlx_video_tpu_torch.models.ltx.upsampler import init_latent_upsampler
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, init_video_decoder
from mlx_video_tpu_torch.models.ltx.video_vae.encoder import init_video_encoder
from mlx_video_tpu_torch.ops import int8 as tint8
from mlx_video_tpu_torch.ops.linear import Int8Linear, QuantLinear
from mlx_video_tpu_torch.pipelines.generate import ModelBundle


def _tiny_bundle() -> ModelBundle:
    cfg = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)
    g = torch.Generator().manual_seed(0)
    dec_cfg = DecoderConfig(in_channels=16, base_channels=32, num_layers_per_block=1)
    return ModelBundle(init_ltx_params(cfg, g, device="cpu", dtype=torch.float32), cfg,
                       init_video_decoder(g, dec_cfg, device="cpu"), dec_cfg,
                       init_latent_upsampler(g, 16, 32, 1, device="cpu"))


def _tiny_dev_bundle() -> ModelBundle:
    """The tiny bundle with a 16-channel VAE encoder (space /32, time /8)."""
    bundle = _tiny_bundle()
    blocks = tuple([("res_x", {"num_layers": 1})] + [(name, {"multiplier": 1}) for name in (
        "compress_space_res", "compress_time_res", "compress_all_res", "compress_all_res")])
    bundle.vae_encoder_config = VideoVAEConfig(out_channels=16, latent_channels=16, encoder_blocks=blocks)
    bundle.vae_encoder = init_video_encoder(torch.Generator().manual_seed(1), bundle.vae_encoder_config, device="cpu")
    return bundle


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


def _dev_files(tmp_path, with_neg: bool):
    rng = np.random.default_rng(2)
    emb = {"video": rng.standard_normal((8, 48)).astype(np.float32)}
    if with_neg:
        emb["video_neg"] = rng.standard_normal((8, 48)).astype(np.float32)
    save_safetensors(tmp_path / "dev_emb.safetensors", emb)
    Image.fromarray(rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)).save(tmp_path / "img.png")
    return tmp_path / "dev_emb.safetensors", tmp_path / "img.png"


def test_main_dev_pipeline_with_an_image(monkeypatch, tmp_path):
    """--pipeline dev --cfg-scale 4.5 --image img.png 0 1.0 with video and
    video_neg embeddings writes an mp4 and a phase JSON."""
    emb, image = _dev_files(tmp_path, with_neg=True)
    calls = []
    monkeypatch.setattr(loading, "load_model_bundle", lambda *a, **kw: calls.append(kw) or _tiny_dev_bundle())
    out = tmp_path / "dev.mp4"
    cli.main(["--prompt", "p", "--checkpoint-path", str(tmp_path), "--embeddings", str(emb), "--pipeline", "dev",
              "--cfg-scale", "4.5", "--image", str(image), "0", "1.0", "--steps", "2", "--height", "64", "--width",
              "64", "--num-frames", "9", "--tiling", "none", "--output-path", str(out), "--profile-json-path",
              str(tmp_path / "phases.json"), "--device", "cpu"])
    assert out.stat().st_size > 0
    assert calls[0]["pipeline"] == "dev" and calls[0]["load_encoder"] is True
    phases = json.loads((tmp_path / "phases.json").read_text())["phases"]
    assert set(phases) == {"load", "cond_encode", "dev_denoise", "vae_decode"}


@pytest.mark.parametrize("with_neg, extra, batches", [
    (False, (), [1, 1]), (True, (), [2, 2]), (True, ("--no-cfg-batch",), [1, 1, 1, 1]),
])
def test_main_dev_cfg_follows_the_embeddings(monkeypatch, tmp_path, with_neg, extra, batches):
    """Without video_neg the dev run has no CFG (as the JAX CLI: denoise's
    use_cfg is false); with it, one doubled forward a step, or two with
    --no-cfg-batch."""
    from mlx_video_tpu_torch.pipelines import denoise as dn

    emb, image = _dev_files(tmp_path, with_neg)
    seen = []
    forward = dn.ltx_apply
    monkeypatch.setattr(dn, "ltx_apply", lambda m, c, v, a: seen.append(v.latent.shape[0]) or forward(m, c, v, a))
    monkeypatch.setattr(loading, "load_model_bundle", lambda *a, **kw: _tiny_dev_bundle())
    cli.main(["--prompt", "p", "--checkpoint-path", str(tmp_path), "--embeddings", str(emb), "--pipeline", "dev",
              "--condition-image", str(image), "--steps", "2", "--height", "64", "--width", "64", "--num-frames", "9",
              "--latents-only", "--device", "cpu", *extra])
    assert seen == batches


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
    (["--pipeline-parallel", "1"], "--pipeline-parallel"),
    (["--cfg-cache-interval", "2"], "--cfg-cache-interval"),
    (["--attn-broadcast-interval", "2"], "--attn-broadcast-interval"),
    (["--mesh", "auto"], "--mesh"),
    (["--mem-log"], "--mem-log"),
    (["--sequence-parallel"], "--sequence-parallel"),
    (["--profile"], "--profile"),
    (["--teacache-threshold", "0.1"], "--teacache-threshold"),
    (["--enhance-prompt"], "--enhance-prompt"),
    (["--low-memory"], "--low-memory"),
    (["--temperature", "0.2"], "--temperature"),
    (["--trace-dir", "x"], "--trace-dir"),
])
def test_unported_flags_exit_with_their_names(monkeypatch, tmp_path, emb_file, flags, named):
    """The port refuses no flag of the JAX CLI: the dials, the enhancement
    flags, the instrumentation flags and the memory plan's --low-memory are
    taken and the run goes on (as in the JAX CLI, --enhance-prompt does
    nothing on --embeddings; a trace lands under the working directory)."""
    monkeypatch.chdir(tmp_path)
    assert not hasattr(cli, "_REFUSED") and named in {a for act in cli.build_parser()._actions
                                                      for a in act.option_strings}
    assert _run_main(monkeypatch, tmp_path, emb_file, _tiny_bundle(), flags).stat().st_size > 0


def test_enhance_prompt_exits_on_the_prompt_path(monkeypatch, tmp_path):
    """On the prompt path --enhance-prompt (ported in PR 15) rewrites the
    prompt with the text encoder first: the T2V chat, or the I2V one with
    --image, at --temperature for --max-tokens; the enhanced prompt is what
    gets encoded."""
    from mlx_video_tpu_torch.models.ltx import text_encoder as tte

    calls = []

    class Fake:
        def enhance_t2v(self, prompt, **kw):
            calls.append(("t2v", prompt, kw))
            return prompt + ", enhanced"

        def enhance_i2v(self, prompt, **kw):
            calls.append(("i2v", prompt, kw))
            return prompt + ", enhanced i2v"

        def encode(self, prompt):
            calls.append(("encode", prompt))
            return torch.zeros(1, 8, 48), None

    monkeypatch.setattr(tte.LTX2TextEncoder, "load", lambda *a, **kw: Fake())
    monkeypatch.setattr(loading, "load_model_bundle", lambda *a, **kw: _tiny_dev_bundle())
    _, image = _dev_files(tmp_path, with_neg=False)
    for extra, mode, suffix in (([], "t2v", ", enhanced"), (["--image", str(image), "0", "1.0"], "i2v", ", enhanced i2v")):
        calls.clear()
        cli.main(["--prompt", "p", "--enhance-prompt", "--temperature", "0.3", "--max-tokens", "7", "--checkpoint-path",
                  str(tmp_path), "--height", "64", "--width", "64", "--num-frames", "9", "--stage1-steps", "1",
                  "--stage2-steps", "1", "--latents-only", "--device", "cpu", *extra])
        assert calls == [(mode, "p", {"temperature": 0.3, "max_new_tokens": 7}), ("encode", "p" + suffix)]


@pytest.mark.parametrize("flag, kind", [("--w8a8", Int8Linear), ("--w4a8", QuantLinear)])
def test_main_runs_w8a8_and_w4a8(monkeypatch, tmp_path, emb_file, flag, kind):
    """--w8a8: the block linears become Int8Linears; --w4a8: 4-bit storage
    (no quantization.json, no hint: 4) with int8 scales. Every block linear
    then runs one int8 product a forward: 10 x 2 layers x (1 + 1) steps."""
    bundle = _tiny_bundle()
    before = tint8.int8_matmul_count
    out = _run_main(monkeypatch, tmp_path, emb_file, bundle, (flag,))
    assert out.stat().st_size > 0
    layers = [m for m in bundle.transformer.modules() if isinstance(m, kind)]
    assert len(layers) == 10 * bundle.transformer_config.num_layers
    if kind is QuantLinear:
        assert {m.bits for m in layers} == {4} and all(m.int8_scale is not None for m in layers)
    assert tint8.int8_matmul_count - before == 10 * bundle.transformer_config.num_layers * 2


def test_w8a8_and_w4a8_exclude_each_other(monkeypatch, emb_file):
    monkeypatch.setattr(loading, "load_model_bundle", lambda *a, **kw: _tiny_bundle())
    with pytest.raises(SystemExit, match="exclusive"):
        cli.main(["--prompt", "p", "--embeddings", str(emb_file), "--device", "cpu", "--w8a8", "--w4a8",
                  "--checkpoint-path", str(emb_file.parent)])


@pytest.fixture
def text_encoder_dir(tmp_path):
    """A tiny text-encoder snapshot (Gemma-3 of 48 channels, the DiT's caption
    width; connectors; a BPE tokenizer) written from seeded port weights."""
    from test_torch_port_text_encoder import GEMMA, write_text_encoder_snapshot

    from mlx_video_tpu_torch.models.gemma3 import Gemma3TextConfig, init_gemma3_params
    from mlx_video_tpu_torch.models.ltx.text_encoder import init_text_encoder_params

    cfg = Gemma3TextConfig(**GEMMA)
    g = torch.Generator().manual_seed(3)
    model = init_text_encoder_params(cfg, g, cfg.hidden_size, device="cpu", dtype=torch.float32,
                                     language_model=init_gemma3_params(cfg, g, device="cpu", dtype=torch.float32))
    write_text_encoder_snapshot(tmp_path / "te", model)
    return tmp_path / "te"


@pytest.mark.parametrize("extra", [(), ("--w8a8",)])
def test_main_encodes_the_prompt_with_the_text_encoder(monkeypatch, tmp_path, text_encoder_dir, extra):
    """A prompt without --embeddings goes through the Gemma-3 text encoder
    of --text-encoder-path (in W8A8 with --w8a8) to an mp4."""
    from mlx_video_tpu_torch.models.ltx import text_encoder as tte

    loads, load = [], tte.LTX2TextEncoder.load

    def spy(*args, **kwargs):
        enc = load(*args, **kwargs)
        loads.append((kwargs, sum(isinstance(m, Int8Linear) for m in enc.model.modules())))
        return enc

    monkeypatch.setattr(tte.LTX2TextEncoder, "load", spy)
    monkeypatch.setattr(loading, "load_model_bundle", lambda *a, **kw: _tiny_bundle())
    out = tmp_path / "p.mp4"
    cli.main(["--prompt", "a cat in the rain", "--checkpoint-path", str(text_encoder_dir), "--text-encoder-path",
              str(text_encoder_dir), "--height", "64", "--width", "64", "--num-frames", "9", "--stage1-steps", "1",
              "--stage2-steps", "1", "--tiling", "none", "--output-path", str(out), "--profile-json-path",
              str(tmp_path / "phases.json"), "--device", "cpu", *extra])
    assert out.stat().st_size > 0
    phases = json.loads((tmp_path / "phases.json").read_text())["phases"]
    assert {"load", "text_encoder_load", "text_encode", "stage1_denoise", "vae_decode"} <= set(phases)
    (kwargs, n_int8), = loads
    assert kwargs["w8a8"] == bool(extra) and n_int8 == (7 * 4 + 1 if extra else 0)


def test_main_dev_prompt_encodes_the_default_negative_prompt(monkeypatch, tmp_path, text_encoder_dir):
    """The dev pipeline without --negative-prompt encodes the default one, so
    CFG runs (one doubled forward a step), as the JAX CLI."""
    from mlx_video_tpu_torch.pipelines import denoise as dn

    seen, forward = [], dn.ltx_apply
    monkeypatch.setattr(dn, "ltx_apply", lambda m, c, v, a: seen.append(v.latent.shape[0]) or forward(m, c, v, a))
    monkeypatch.setattr(loading, "load_model_bundle", lambda *a, **kw: _tiny_dev_bundle())
    cli.main(["--prompt", "p", "--checkpoint-path", str(text_encoder_dir), "--pipeline", "dev", "--steps", "2",
              "--height", "64", "--width", "64", "--num-frames", "9", "--latents-only", "--device", "cpu"])
    assert seen == [2, 2]


def test_cuda_device_without_cuda_exits(emb_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(["--prompt", "p", "--embeddings", str(emb_file)])


def test_parser_keeps_the_jax_flag_names():
    from mlx_video_tpu.cli.generate import build_parser as jax_parser

    ours = {a for action in cli.build_parser()._actions for a in action.option_strings}
    theirs = {a for action in jax_parser()._actions for a in action.option_strings}
    assert ours - theirs == {"--device"} and theirs <= ours
    assert not hasattr(cli, "_REFUSED")


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


# --- LoRA merges, a stage-2 transformer, the conditioned pipelines, batches ---

def _adapter_file(path, seed: int):
    """A reference-format adapter on the attention linears of both layers of
    the tiny DiT."""
    rng = np.random.default_rng(seed)
    d = tiny_test_config().inner_dim
    state = {}
    for i in (0, 1):
        for lin in ("attn1.to_q", "attn1.to_k", "attn2.to_v", "attn2.to_out.0"):
            key = f"diffusion_model.transformer_blocks.{i}.{lin}"
            state[f"{key}.lora_A.weight"] = rng.normal(size=(4, d)).astype(np.float32) * 0.1
            state[f"{key}.lora_B.weight"] = rng.normal(size=(d, 4)).astype(np.float32) * 0.1
    save_safetensors(path, state)
    return path


def test_main_lora_then_quantize_equals_a_merge_followed_by_quantization(monkeypatch, tmp_path, emb_file, capsys):
    """--lora A --lora-strength 0.5 --quantize-bits 4: the adapter is merged
    into the dense weights first, then the DiT is quantized (as the JAX CLI:
    a merge into 4-bit words would be skipped)."""
    from mlx_video_tpu_torch.lora import LoraSpec, merge_lora_into_params
    from mlx_video_tpu_torch.ops.quant import quantize_dit_params

    adapter = _adapter_file(tmp_path / "a.safetensors", 1)
    bundle = _tiny_bundle()
    out = _run_main(monkeypatch, tmp_path, emb_file, bundle,
                    ("--lora", str(adapter), "--lora-strength", "0.5", "--quantize-bits", "4"))
    assert out.stat().st_size > 0 and f"[LoRA] {adapter} applied=8 skipped=0" in capsys.readouterr().out
    want = merge_lora_into_params(_tiny_bundle().transformer, [LoraSpec(adapter, 0.5)])
    quantize_dit_params(want, bits=4)
    got = bundle.transformer.state_dict()
    assert set(got) == set(want.state_dict())
    for k, v in want.state_dict().items():
        assert torch.equal(got[k], v), k
    assert {"load", "lora_merge"} <= set(json.loads((tmp_path / "phases.json").read_text())["phases"])


@pytest.mark.parametrize("with_stage2", [False, True])
def test_main_distilled_lora_merges_into_the_stage2_transformer(monkeypatch, tmp_path, emb_file, with_stage2):
    """--distilled-lora: merged into the stage-2 transformer, or, without
    one, into a copy of the transformer that then refines stage 2; the
    stage-1 transformer keeps its weights."""
    from mlx_video_tpu_torch.lora import LoraSpec, merge_lora_into_params
    from mlx_video_tpu_torch.pipelines import denoise as dn

    adapter = _adapter_file(tmp_path / "d.safetensors", 2)
    bundle = _tiny_bundle()
    if with_stage2:
        bundle.stage2_transformer = init_ltx_params(bundle.transformer_config, torch.Generator().manual_seed(5),
                                                    device="cpu", dtype=torch.float32)
    stage1, base = bundle.transformer, bundle.stage2_transformer or bundle.transformer
    before = {k: v.clone() for k, v in stage1.state_dict().items()}
    seen, forward = [], dn.ltx_apply
    monkeypatch.setattr(dn, "ltx_apply", lambda m, c, v, a: seen.append(m) or forward(m, c, v, a))
    _run_main(monkeypatch, tmp_path, emb_file, bundle, ("--distilled-lora", str(adapter)))
    assert bundle.transformer is stage1 and seen[0] is stage1 and seen[-1] is bundle.stage2_transformer
    for k, v in stage1.state_dict().items():
        assert torch.equal(v, before[k]), k
    want = merge_lora_into_params(base, [LoraSpec(adapter, 1.0)]).state_dict()
    for k, v in bundle.stage2_transformer.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_main_stage2_model_repo_loads_a_second_transformer(monkeypatch, tmp_path, emb_file):
    stage2_dir = tmp_path / "stage2"
    stage2_dir.mkdir()
    calls = []

    def fake_load(*args, **kwargs):
        calls.append(kwargs)
        return _tiny_bundle()

    monkeypatch.setattr(loading, "load_model_bundle", fake_load)
    cli.main(["--prompt", "p", "--checkpoint-path", str(tmp_path), "--embeddings", str(emb_file),
              "--stage2-model-repo", str(stage2_dir), "--height", "64", "--width", "64", "--num-frames", "9",
              "--stage1-steps", "1", "--stage2-steps", "1", "--latents-only", "--device", "cpu"])
    assert calls[0]["stage2_path"] == stage2_dir and calls[0]["load_encoder"] is False


def _write_clip(path, frames: int = 9, size: int = 64):
    import cv2

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 24.0, (size, size))
    rng = np.random.default_rng(3)
    for _ in range(frames):
        writer.write(rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8))
    writer.release()
    return path


@pytest.mark.parametrize("pipeline", ["keyframe", "ic_lora", "distilled"])
def test_main_conditioned_distilled_pipelines(monkeypatch, tmp_path, emb_file, pipeline):
    """--pipeline keyframe with two images (guide mode), ic_lora with
    --reference-video, distilled with --image and --video-conditioning; all
    streamed, with uniformly subsampled sigmas, to an mp4."""
    image = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(4).integers(0, 256, size=(64, 64, 3), dtype=np.uint8)).save(image)
    clip = str(_write_clip(tmp_path / "ref.mp4"))
    extra = {
        "keyframe": ["--image", str(image), "0", "1.0", "--image", str(image), "8", "0.8"],
        "ic_lora": ["--reference-video", clip],
        "distilled": ["--condition-image", str(image), "--video-conditioning", clip, "0", "0.9"],
    }[pipeline]
    calls = []
    monkeypatch.setattr(loading, "load_model_bundle", lambda *a, **kw: calls.append(kw) or _tiny_dev_bundle())
    out = tmp_path / "c.mp4"
    cli.main(["--prompt", "p", "--checkpoint-path", str(tmp_path), "--embeddings", str(emb_file), "--pipeline",
              pipeline, "--height", "64", "--width", "64", "--num-frames", "9", "--stage1-steps", "2",
              "--stage2-steps", "1", "--stream", "--sigma-subsample", "uniform", "--output-path", str(out),
              "--profile-json-path", str(tmp_path / "phases.json"), "--device", "cpu", *extra])
    assert out.stat().st_size > 0
    assert calls[0]["pipeline"] == pipeline and calls[0]["load_encoder"] is True
    assert "cond_encode" in json.loads((tmp_path / "phases.json").read_text())["phases"]


def test_main_num_videos_writes_one_mp4_and_one_frame_folder_a_video(monkeypatch, tmp_path, emb_file):
    _run_main(monkeypatch, tmp_path, emb_file, _tiny_bundle(), ("--num-videos", "2", "--save-frames"))
    for i in (0, 1):
        assert (tmp_path / f"out_{i}.mp4").stat().st_size > 0
        assert sorted(p.name for p in (tmp_path / f"out_{i}").iterdir()) == [f"frame_{n:05d}.png" for n in range(9)]
    assert not (tmp_path / "out.mp4").exists()


def test_main_conditioning_mode_is_accepted_and_changes_nothing(monkeypatch, tmp_path, emb_file):
    """As the JAX CLI, which parses --conditioning-mode and never reads it
    (the pipeline decides the mode): the same run, the same latents."""
    from mlx_video_tpu_torch.pipelines import generate as tgen

    image = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(5).integers(0, 256, size=(64, 64, 3), dtype=np.uint8)).save(image)
    results, run = [], tgen.generate_video
    monkeypatch.setattr(tgen, "generate_video", lambda *a, **kw: results.append(run(*a, **kw)) or results[-1])
    for extra in ((), ("--conditioning-mode", "guide")):
        _run_main(monkeypatch, tmp_path, emb_file, _tiny_dev_bundle(), ("--image", str(image), "--latents-only",
                                                                        *extra))
    np.testing.assert_array_equal(results[0].latents, results[1].latents)


def test_main_stage2_dev_runs_cfg_at_stage2(monkeypatch, tmp_path):
    """--stage2-dev with a video_neg entry: stage 1 without CFG, stage 2 with
    one doubled forward a step (batched), or two with --no-cfg-batch."""
    from mlx_video_tpu_torch.pipelines import denoise as dn

    emb, _ = _dev_files(tmp_path, with_neg=True)
    seen, forward = [], dn.ltx_apply
    monkeypatch.setattr(dn, "ltx_apply", lambda m, c, v, a: seen.append(v.latent.shape[0]) or forward(m, c, v, a))
    for extra, want in (((), [1, 1, 2]), (("--no-cfg-batch",), [1, 1, 1, 1])):
        seen.clear()
        _run_main(monkeypatch, tmp_path, emb, _tiny_bundle(), ("--stage2-dev", "--stage1-steps", "2", "--latents-only",
                                                               *extra))
        assert seen == want


def test_main_stage2_dev_prompt_encodes_the_default_negative_prompt(monkeypatch, tmp_path, text_encoder_dir):
    """--stage2-dev without --negative-prompt encodes the default one, as the
    JAX CLI, so stage 2 runs CFG."""
    from mlx_video_tpu_torch.pipelines import denoise as dn

    seen, forward = [], dn.ltx_apply
    monkeypatch.setattr(dn, "ltx_apply", lambda m, c, v, a: seen.append(v.latent.shape[0]) or forward(m, c, v, a))
    monkeypatch.setattr(loading, "load_model_bundle", lambda *a, **kw: _tiny_bundle())
    cli.main(["--prompt", "p", "--checkpoint-path", str(text_encoder_dir), "--stage2-dev", "--stage1-steps", "1",
              "--stage2-steps", "1", "--height", "64", "--width", "64", "--num-frames", "9", "--latents-only",
              "--device", "cpu"])
    assert seen == [1, 2]


# --- audio ---

def _tiny_av_bundle(joint: bool = True) -> ModelBundle:
    """A tiny AudioVideo (joint) or VideoOnly + AudioOnly (separate) bundle
    with a narrow audio VAE decoder and vocoder; 128-wide audio tokens."""
    import dataclasses

    from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import AudioVAEConfig, init_audio_decoder
    from mlx_video_tpu_torch.models.ltx.audio_vae.vocoder import VocoderConfig, init_vocoder

    bundle = _tiny_bundle()
    g = torch.Generator().manual_seed(5)
    av = dataclasses.replace(tiny_test_config(LTXModelType.AudioVideo, rope_type=LTXRopeType.SPLIT),
                             audio_in_channels=128, audio_out_channels=128)
    if joint:
        bundle.transformer_config = av
        bundle.transformer = init_ltx_params(av, g, device="cpu", dtype=torch.float32)
    else:
        bundle.audio_transformer_config = dataclasses.replace(av, model_type=LTXModelType.AudioOnly)
        bundle.audio_transformer = init_ltx_params(bundle.audio_transformer_config, g, device="cpu",
                                                   dtype=torch.float32)
    bundle.audio_decoder_config, bundle.vocoder_config = AudioVAEConfig(ch=8), VocoderConfig(upsample_initial_channel=32)
    bundle.audio_decoder = init_audio_decoder(g, bundle.audio_decoder_config, device="cpu", dtype=torch.float32)
    bundle.vocoder = init_vocoder(g, bundle.vocoder_config, device="cpu", dtype=torch.float32)
    return bundle


def _av_emb_file(tmp_path, keys=("video", "video_neg", "audio", "audio_neg")):
    rng = np.random.default_rng(4)
    path = tmp_path / "av_emb.safetensors"
    save_safetensors(path, {k: rng.standard_normal((8, 48)).astype(np.float32) for k in keys})
    return path


@pytest.mark.parametrize("flags, env, want", [
    (["--audio"], None, dict(audio=True, audio_mode="auto", audio_steps=8, audio_filter=None, audio_bitrate="256k",
                             output_audio_path=None)),
    (["--audio", "--skip-audio"], None, dict(audio=False)),
    (["--skip-audio"], None, dict(audio=False)),
    (["--audio"], "320k", dict(audio=True, audio_bitrate="320k")),
    (["--audio", "--audio-bitrate", "96k"], "320k", dict(audio_bitrate="96k")),
    (["--audio", "--audio-mode", "joint", "--audio-steps", "3", "--audio-filter", "volume=2", "--output-audio",
      "x.wav"], None, dict(audio_mode="joint", audio_steps=3, audio_filter="volume=2", output_audio_path="x.wav")),
])
def test_main_passes_the_audio_flags(monkeypatch, tmp_path, emb_file, flags, env, want):
    """Every audio flag reaches the loader and generate_video: --skip-audio
    wins over --audio, --audio-bitrate falls back to $LTX_AUDIO_BITRATE and
    then 256k, --output-audio sets the WAV path."""
    from mlx_video_tpu_torch.pipelines import generate as tgen

    if env is None:
        monkeypatch.delenv("LTX_AUDIO_BITRATE", raising=False)
    else:
        monkeypatch.setenv("LTX_AUDIO_BITRATE", env)
    loads, runs = [], []
    monkeypatch.setattr(loading, "load_model_bundle", lambda *a, **kw: loads.append(kw) or _tiny_bundle())
    monkeypatch.setattr(tgen, "generate_video", lambda *a, **kw: runs.append(kw) or tgen.GenerateResult(None, None))
    cli.main(["--prompt", "p", "--checkpoint-path", str(tmp_path), "--embeddings", str(emb_file), "--device", "cpu",
              *flags])
    (load,), (run,) = loads, runs
    assert {k: run[k] for k in want} == want
    assert load["audio"] is run["audio"] and load["audio_mode"] == run["audio_mode"] == want.get("audio_mode", "auto")
    assert load["audio_model_path"] is None


def test_main_resolves_the_audio_model_repo(monkeypatch, tmp_path):
    loads = []
    monkeypatch.setattr(loading, "load_model_bundle", lambda *a, **kw: loads.append(kw) or _tiny_av_bundle())
    (tmp_path / "audio_repo").mkdir()
    cli.main(["--prompt", "p", "--checkpoint-path", str(tmp_path), "--embeddings", str(_av_emb_file(tmp_path)),
              "--device", "cpu", "--height", "64", "--width", "64", "--num-frames", "9", "--stage1-steps", "1",
              "--stage2-steps", "1", "--audio", "--latents-only",
              "--audio-model-repo", str(tmp_path / "audio_repo"), "--audio-mode", "joint"])
    assert loads[0]["audio_model_path"] == tmp_path / "audio_repo"


@pytest.mark.parametrize("keys", [("video", "video_neg", "audio", "audio_neg"), ("video", "audio_prompt_embeds")])
def test_load_embeddings_reads_the_audio_contexts(tmp_path, keys):
    path = _av_emb_file(tmp_path, keys)
    text = cli.load_embeddings(path)
    assert text.audio_embeddings.shape == (1, 8, 48)
    assert (text.audio_neg_embeddings is None) == ("audio_neg" not in keys)
    assert (text.video_neg_embeddings is None) == ("video_neg" not in keys)


@pytest.mark.parametrize("mode", ["joint", "separate"])
def test_main_generates_audio_to_a_wav(monkeypatch, tmp_path, mode):
    """The whole CLI path with --audio on a tiny bundle: the audio contexts
    from the embeddings file, the WAV beside the mp4 (no ffmpeg here: the
    silent video is the output, as in the JAX CLI)."""
    import wave

    from mlx_video_tpu_torch.io import media

    monkeypatch.setattr(media.shutil, "which", lambda name: None)
    monkeypatch.setattr(loading, "load_model_bundle", lambda *a, **kw: _tiny_av_bundle(joint=mode == "joint"))
    out = tmp_path / "av.mp4"
    cli.main(["--prompt", "p", "--checkpoint-path", str(tmp_path), "--embeddings", str(_av_emb_file(tmp_path)),
              "--height", "64", "--width", "64", "--num-frames", "9", "--stage1-steps", "1", "--stage2-steps", "1",
              "--audio-steps", "2", "--tiling", "none", "--output-path", str(out), "--profile-json-path",
              str(tmp_path / "phases.json"), "--device", "cpu", "--audio", "--audio-mode", mode])
    assert out.stat().st_size > 0 and not (tmp_path / "av.temp.mp4").exists()
    with wave.open(str(tmp_path / "av.wav"), "rb") as wf:
        assert wf.getnchannels() == 2 and wf.getnframes() == 240 * (4 * 9 - 3)  # 9 audio latent frames at 9 frames
    phases = json.loads((tmp_path / "phases.json").read_text())["phases"]
    assert {"audio_decode", "audio_mux"} <= set(phases) and ("audio_denoise" in phases) == (mode == "separate")


def test_encode_prompts_returns_the_audio_contexts(monkeypatch, tmp_path):
    """The prompt's and the negative prompt's audio contexts come from the
    same encodes as the video ones."""
    from mlx_video_tpu_torch.models.ltx import text_encoder as tte

    class Fake:
        def encode(self, prompt):
            v = torch.full((1, 2, 4), float(len(prompt)))
            return v, -v

    monkeypatch.setattr(tte.LTX2TextEncoder, "load", lambda *a, **kw: Fake())
    args = cli.build_parser().parse_args(["--prompt", "abc", "--negative-prompt", "xy", "--device", "cpu"])
    text = cli.encode_prompts(args, tmp_path, torch.device("cpu"), torch.float32, {})
    assert float(text.audio_embeddings[0, 0, 0]) == -3.0 and float(text.audio_neg_embeddings[0, 0, 0]) == -2.0
    assert float(text.video_embeddings[0, 0, 0]) == 3.0
