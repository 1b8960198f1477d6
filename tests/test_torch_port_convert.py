"""The port's checkpoint converter (``python -m mlx_video_tpu_torch.convert``)
against the JAX converter, on the CPU.

Both converters' ``main`` run on the same PyTorch-layout source: the JAX
package's tiny configurations (VideoOnly and AudioVideo), their tensors drawn
from a seeded numpy generator and written with ``model.diffusion_model.*``
keys as tests/test_tools.py writes them. Bars, each with its reason:
- unquantized (``--dtype f32`` and ``bf16``) and ``--w8a8`` files: equal byte
  for byte (the same casts; the int8 scales divide exactly);
- ``--quantize-bits`` 2/4/8 over the scopes attn1/core/all in groups of
  32/64, ``--dtype f32``: the same keys, dtypes and shapes; codes at most one
  level off and at most 0.1 % of them off, scales and biases within one fp32
  ulp (the quantize bars of tests/test_torch_port_quant.py, set on fp32
  weights: JAX quantizes the stacked layers under ``lax.map``, where XLA
  multiplies by 1/levels); every other tensor equal. On bf16 weights (the
  default ``--dtype``) the coarse grid puts many values exactly half-way
  between two codes, where that one-ulp difference decides the rounding:
  there at most 0.2 % of the codes sit one level off (0.143 % measured at 8
  bits, 0.089 % at 4);
- ``quantization.json``, the header metadata, the report and the "Saved"
  lines: equal text;
- ``--lora`` pre-merge: JAX's applied/skipped counts; merged weights within
  one fp32 ulp, bf16 at most 1e-4 of the elements one bf16 ulp apart (the
  merge bars of tests/test_torch_port_conditioned.py);
- ``--unified``, with and without ``--no-audio``: the same bundle, byte for
  byte;
- every output loads back through the port's ``load_model_bundle`` and
  JAX's ``load_native_params`` to the same tree, bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mlx_video_tpu import convert as jconvert
from mlx_video_tpu.config import LTXModelType, tiny_test_config
from mlx_video_tpu.io import safetensors as jst
from mlx_video_tpu.io import weights as jweights
from mlx_video_tpu.models.ltx import model as jm
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch import convert as tconvert
from mlx_video_tpu_torch import loading as tloading
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig
from test_torch_port_loading import DEC_KW, _assert_same_tree, _decoder_checkpoint
from test_weights_io import _to_pt_checkpoint

MODEL_TYPES = {"video": LTXModelType.VideoOnly, "av": LTXModelType.AudioVideo}


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """model type -> (PT-layout source file, --config JSON file)."""
    root = tmp_path_factory.mktemp("convert_sources")
    out = {}
    for name, model_type in MODEL_TYPES.items():
        cfg = tiny_test_config(model_type)
        rng = np.random.default_rng(7)
        shapes = jax.eval_shape(lambda: jm.init_ltx_params(jax.random.key(0), cfg, dtype=jnp.float32))
        tree = jax.tree.map(lambda s: (rng.normal(size=s.shape) * 0.1).astype(np.float32), shapes)
        src = root / f"{name}-pt.safetensors"
        jst.save_safetensors(src, _to_pt_checkpoint(tree, cfg))
        cfg_file = root / f"{name}.json"
        cfg_file.write_text(json.dumps(cfg.to_dict()))
        out[name] = (src, cfg_file)
    return out


def _convert_both(tmp_path, capsys, sources, model_type="video", args=(), subdir="out"):
    """JAX ``main`` then the port's on the same source and flags; returns
    {"jax"|"port": (output file, stdout with the output directory as OUT)}."""
    src, cfg_file = sources[model_type]
    runs = {}
    for side, main, extra in (("jax", jconvert.main, []), ("port", tconvert.main, ["--device", "cpu"])):
        out_dir = tmp_path / side / subdir
        out = out_dir / "ltx-2-19b-distilled.safetensors"
        main(["-i", str(src), "-o", str(out), "--model-type", model_type, "--config", str(cfg_file), "--report",
              *args, *extra])
        runs[side] = (out, capsys.readouterr().out.replace(str(out_dir), "OUT"))
    return runs


def _read_json(path):
    return path.read_text() if path.exists() else None


def _header(path):
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        return json.loads(f.read(n))


@pytest.mark.parametrize("model_type", ["video", "av"])
@pytest.mark.parametrize("mode", [["--dtype", "f32"], ["--dtype", "bf16"], ["--w8a8"]], ids=["f32", "bf16", "w8a8"])
def test_unquantized_and_w8a8_files_are_byte_equal(tmp_path, capsys, sources, model_type, mode):
    runs = _convert_both(tmp_path, capsys, sources, model_type, mode)
    (jout, jtext), (tout, ttext) = runs["jax"], runs["port"]
    assert tout.read_bytes() == jout.read_bytes()
    assert ttext == jtext and "Saved transformer to OUT/ltx-2-19b-distilled.safetensors" in ttext
    assert _read_json(tout.parent / "quantization.json") == _read_json(jout.parent / "quantization.json")
    lines = [line for line in ttext.splitlines() if line.startswith("  ")]
    assert lines and all(": dense " in line or (": w8a8 int8" in line) == (mode == ["--w8a8"]) for line in lines)


def _codes(words: np.ndarray, bits: int, in_dim: int) -> np.ndarray:
    """LSB-first unpacked codes of (..., words) uint32 rows."""
    shifts = np.arange(0, 32, bits, dtype=np.uint32)
    codes = (words[..., None] >> shifts) & np.uint32((1 << bits) - 1)
    return codes.reshape(*words.shape[:-1], -1)[..., :in_dim].astype(np.int64)


def _check_quantized(tmp_path, capsys, sources, bits, scope, group, dtype, code_share):
    runs = _convert_both(tmp_path, capsys, sources, "video", ["--quantize-bits", str(bits), "--quantize-scope", scope,
                                                              "--quantize-group-size", str(group), "--dtype", dtype])
    (jout, jtext), (tout, ttext) = runs["jax"], runs["port"]
    assert ttext == jtext and ": quantized uint32" in ttext
    assert _read_json(tout.parent / "quantization.json") == _read_json(jout.parent / "quantization.json")
    assert json.loads(_read_json(tout.parent / "quantization.json")) == {
        "bits": bits, "group_size": group, "mode": "affine", "predicate": scope, "dtype": dtype}
    jhead, thead = _header(jout), _header(tout)
    assert thead.pop("__metadata__") == jhead.pop("__metadata__")
    assert list(thead) == list(jhead)
    assert {k: (v["dtype"], v["shape"]) for k, v in thead.items()} == {k: (v["dtype"], v["shape"])
                                                                        for k, v in jhead.items()}
    n_quant = 0
    with jst.SafetensorsReader(jout) as jr, jst.SafetensorsReader(tout) as tr:
        for key in jr.keys():
            ref, got = np.asarray(jr.get(key)), np.asarray(tr.get(key))
            leaf = key.rsplit(".", 1)[-1]
            if leaf == "quant_weight":
                n_quant += 1
                in_dim = ref.shape[-1] * 32 // bits
                cj, ct = _codes(ref, bits, in_dim), _codes(got, bits, in_dim)
                assert np.abs(cj - ct).max() <= 1 and np.mean(cj != ct) <= code_share, key
            elif leaf in ("scales", "biases"):
                np.testing.assert_allclose(got.astype(np.float32), ref.astype(np.float32),
                                           rtol=np.finfo(np.float32).eps, atol=0, err_msg=key)
            else:
                assert ref.tobytes() == got.tobytes(), key
    assert n_quant == {"attn1": 4, "core": 10, "all": 10}[scope]


@pytest.mark.parametrize("group", [32, 64])
@pytest.mark.parametrize("scope", ["attn1", "core", "all"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantized_files_match_jax(tmp_path, capsys, sources, bits, scope, group):
    _check_quantized(tmp_path, capsys, sources, bits, scope, group, "f32", 1e-3)


@pytest.mark.parametrize("bits", [4, 8])
def test_bf16_quantized_files_differ_only_at_ties(tmp_path, capsys, sources, bits):
    _check_quantized(tmp_path, capsys, sources, bits, "core", 64, "bf16", 2e-3)


def _adapter(path, seed: int):
    """Rank-2 factors on the attn1 and ff linears of both blocks, plus a key
    the VideoOnly model has no linear for."""
    rng = np.random.default_rng(seed)
    d, ff = 128, 512
    pairs = [(f"transformer_blocks.{i}.attn1.{lin}", d, d) for i in (0, 1) for lin in ("to_q", "to_k", "to_v",
                                                                                        "to_out.0")]
    pairs += [(f"transformer_blocks.{i}.ff.net.0.proj", d, ff) for i in (0, 1)]
    pairs += [("transformer_blocks.0.audio_attn1.to_q", 64, 64)]
    state = {}
    for key, n_in, n_out in pairs:
        state[f"diffusion_model.{key}.lora_A.weight"] = (rng.normal(size=(2, n_in)) * 0.1).astype(np.float32)
        state[f"diffusion_model.{key}.lora_B.weight"] = (rng.normal(size=(n_out, 2)) * 0.1).astype(np.float32)
    jst.save_safetensors(path, state)
    return path


def _ulps(got: np.ndarray, ref: np.ndarray):
    """(elements that differ, largest difference in ulps of the dtype)."""
    width = np.int16 if got.dtype == ml_dtypes.bfloat16 else np.int32
    diff = np.abs(got.view(width).astype(np.int64) - ref.view(width).astype(np.int64))
    return int((diff > 0).sum()), int(diff.max(initial=0))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lora_premerge_matches_jax(tmp_path, capsys, sources, dtype):
    adapter = _adapter(tmp_path / "adapter.safetensors", 3)
    runs = _convert_both(tmp_path, capsys, sources, "video", ["--dtype", dtype, "--lora", str(adapter),
                                                              "--lora-strength", "0.7"])
    (jout, jtext), (tout, ttext) = runs["jax"], runs["port"]
    assert ttext == jtext and f"[LoRA] {adapter} applied=10 skipped=1" in ttext
    with jst.SafetensorsReader(jout) as jr, jst.SafetensorsReader(tout) as tr:
        assert tr.keys() == jr.keys()
        for key in jr.keys():
            ref, got = np.asarray(jr.get(key)), np.asarray(tr.get(key))
            n, ulps = _ulps(got, ref)
            assert ulps <= 1 and (dtype == "f32" or n <= 1e-4 * got.size), key
        with jst.SafetensorsReader(sources["video"][0]) as sr:
            before = np.asarray(sr.get("model.diffusion_model.transformer_blocks.0.attn1.to_q.weight"))
        after = np.asarray(tr.get("blocks.attn1.to_q.weight"), np.float32)[0].T
        merged = np.abs(after - before.astype(np.float32)).max()
    assert merged > 1e-3  # the adapter moved the weight


def _snapshot(root, bf16_stats: bool = True):
    """A snapshot with vae/ (decoder and encoder tensors under ``vae.``, the
    statistics), audio_vae/ and vocoder/, some tensors bf16."""
    rng = np.random.default_rng(11)
    files = {
        "vae": {"vae.decoder.conv_in.conv.weight": rng.normal(size=(4, 3)).astype(np.float32),
                "vae.encoder.conv_out.conv.bias": rng.normal(size=(5,)).astype(ml_dtypes.bfloat16),
                "per_channel_statistics.mean-of-means": rng.normal(size=(16,)).astype(
                    ml_dtypes.bfloat16 if bf16_stats else np.float32),
                "vae.ignored.x": np.zeros((2,), np.float32)},
        "audio_vae": {"audio_vae.decoder.conv_in.weight": rng.normal(size=(3, 2)).astype(ml_dtypes.bfloat16),
                      "per_channel_statistics.std-of-means": rng.normal(size=(8,)).astype(np.float32)},
        "vocoder": {"vocoder.conv_pre.weight": rng.normal(size=(2, 2, 3)).astype(np.float32),
                    "ups.0.weight": rng.normal(size=(2,)).astype(ml_dtypes.bfloat16)},
    }
    for name, tensors in files.items():
        (root / name).mkdir(parents=True)
        jst.save_safetensors(root / name / "diffusion_pytorch_model.safetensors", tensors)
    return root


@pytest.mark.parametrize("no_audio", [False, True], ids=["audio", "no_audio"])
def test_unified_bundle_matches_jax(tmp_path, capsys, sources, no_audio):
    snap = _snapshot(tmp_path / "snap")
    runs = _convert_both(tmp_path, capsys, sources, "av", ["--unified", "--model-path", str(snap),
                                                           *(["--no-audio"] if no_audio else [])])
    (jout, jtext), (tout, ttext) = runs["jax"], runs["port"]
    assert ttext == jtext
    jbundle, tbundle = jout.parent / "model.safetensors", tout.parent / "model.safetensors"
    assert tbundle.read_bytes() == jbundle.read_bytes()
    with jst.SafetensorsReader(tbundle) as r:
        assert r.metadata == {"format": "mlx_video_tpu_unified"}
        prefixes = {k.split(".", 1)[0] for k in r.keys()}
        assert {"vae_decoder.per_channel_statistics.mean-of-means",
                "vae_encoder.per_channel_statistics.mean-of-means", "vae_encoder.conv_out.conv.bias"} <= set(r.keys())
        assert r.get("vae_encoder.conv_out.conv.bias").dtype == ml_dtypes.bfloat16
    assert prefixes == {"transformer", "vae_decoder", "vae_encoder"} | (set() if no_audio else {"audio_vae", "vocoder"})


def test_w8a8_with_quantize_bits_raises_the_jax_error(tmp_path, sources):
    src, cfg_file = sources["video"]
    messages = []
    for main, extra in ((jconvert.main, []), (tconvert.main, ["--device", "cpu"])):
        with pytest.raises(ValueError) as info:
            main(["-i", str(src), "-o", str(tmp_path / "x.safetensors"), "--model-type", "video", "--config",
                  str(cfg_file), "--w8a8", "--quantize", *extra])
        messages.append(str(info.value))
    assert messages[0] == messages[1] and "mutually exclusive" in messages[0]


def test_cuda_device_without_cuda_exits(tmp_path, sources, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tconvert.main(["-i", str(sources["video"][0]), "-o", str(tmp_path / "x.safetensors")])


@pytest.mark.parametrize("mode", [["--dtype", "f32"], ["--dtype", "bf16"], ["--w8a8"], ["--quantize"],
                                  ["--quantize", "--unified"]], ids=["f32", "bf16", "w8a8", "q4", "q4_unified"])
def test_outputs_load_back_to_the_same_tree(tmp_path, capsys, sources, monkeypatch, mode):
    """The port's load_model_bundle on the port's output directory (the
    unified bundle when there is one) and JAX's load_native_params on the
    same file give one tree."""
    runs = _convert_both(tmp_path, capsys, sources, "video", mode)
    jout, tout = runs["jax"][0], runs["port"][0]
    unified = "--unified" in mode
    if unified:
        assert tloading.unified_bundle_file(tout.parent) == tout.parent / "model.safetensors"
    else:
        (tout.parent / "vae").mkdir()
        _decoder_checkpoint(tout.parent / "vae" / "diffusion_pytorch_model.safetensors")
    tcfg = tconfig.LTXModelConfig.from_dict(tiny_test_config(LTXModelType.VideoOnly).to_dict())
    monkeypatch.setattr(tloading, "model_config_for", lambda *a, **kw: tcfg)
    monkeypatch.setattr(tloading, "DecoderConfig", lambda: DecoderConfig(**DEC_KW))
    if unified:  # the bundle's VAE part is this test's stand-in; the decoder loader is tested elsewhere
        monkeypatch.setattr(tloading.vae_weights, "load_video_decoder_weights", lambda *a: None)
    dtype = torch.float32 if mode == ["--dtype", "f32"] else torch.bfloat16
    bundle = tloading.load_model_bundle(tout.parent, device="cpu", dtype=dtype)
    ref = jweights.load_native_params(tout.parent / "model.safetensors", prefix="transformer.") if unified else \
        jweights.load_native_params(tout)
    _assert_same_tree(ref, jax_bridge.module_to_jax_tree(bundle.transformer))
    if "--quantize" not in mode:  # and the JAX converter's file is the same file
        assert jout.read_bytes() == tout.read_bytes()
