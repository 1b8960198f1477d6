"""The port's safetensors I/O and checkpoint loaders against the JAX
package's, on files the JAX side writes, on the CPU.

Every comparison is bit-exact: both loaders read the same bytes, and the port
tree goes back to the JAX layout through io/jax_bridge.py (bf16 widened to
fp32, which is exact; uint32 words compared as words). Layouts covered: the
PyTorch ``model.diffusion_model.*`` keys, sanitized MLX keys, MLX
pre-quantized linears (uint32 words, bf16 scales and biases), the native
``format: mlx_video_tpu`` file and the unified ``model.safetensors`` bundle.
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mlx_video_tpu import loading as jloading
from mlx_video_tpu.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu.convert import build_unified_bundle
from mlx_video_tpu.io import safetensors as jst
from mlx_video_tpu.io import vae_weights as jvae
from mlx_video_tpu.io import weights as jweights
from mlx_video_tpu.models.ltx import model as jm
from mlx_video_tpu.models.ltx.upsampler import init_latent_upsampler as jax_init_upsampler
from mlx_video_tpu.models.ltx.video_vae.decoder import DecoderConfig as JaxDecoderConfig
from mlx_video_tpu.models.ltx.video_vae.decoder import init_video_decoder as jax_init_decoder
from mlx_video_tpu.ops import quant as jquant
from mlx_video_tpu.pipelines.positions import create_position_grid
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch import loading as tloading
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.io import safetensors as tst
from mlx_video_tpu_torch.io import vae_weights as tvae
from mlx_video_tpu_torch.io import weights as tweights
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.models.ltx.upsampler import LatentUpsampler, init_latent_upsampler
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, VideoDecoder, init_video_decoder
from mlx_video_tpu_torch.ops.linear import Linear, QuantLinear
from mlx_video_tpu_torch.ops.quant import quantize_linear
from mlx_video_tpu_torch.pipelines.generate import ModelBundle, TextConditioning, generate_video

CFG = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)
TCFG = tconfig.LTXModelConfig.from_dict(CFG.to_dict())  # the port's own config class
DEC_KW = dict(in_channels=16, base_channels=32, num_layers_per_block=2, num_upsamples=3, patch_size=4)


# --- checkpoint writers (test helpers: the packages have no such writers) ---

_DESANITIZE = ((".to_out.", ".to_out.0."), (".ff.proj_in.", ".ff.net.0.proj."), (".ff.proj_out.", ".ff.net.2."),
               (".linear1.", ".linear_1."), (".linear2.", ".linear_2."))


def _mlx_key(name: str) -> str:
    """Port state name -> sanitized MLX key (packed words under ``.weight``)."""
    key = "transformer_blocks." + name[len("blocks."):] if name.startswith("blocks.") else name[len("video."):]
    return key[: -len("quant_weight")] + "weight" if key.endswith(".quant_weight") else key


def _pt_key(name: str) -> str:
    key = _mlx_key(name)
    for sanitized, raw in _DESANITIZE:
        key = key.replace(sanitized, raw)
    return "model.diffusion_model." + key


def _np(t: torch.Tensor) -> np.ndarray:
    """Torch tensor -> numpy with the same bits (bf16 via ml_dtypes, int32
    words as uint32)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if t.dtype == torch.int32:
        return t.numpy().view(np.uint32)
    return t.numpy()


def _dense_model() -> tm.LTXModel:
    model = tm.init_ltx_params(TCFG, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bias", "scale_shift_table")) or "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return model


def _jax_tree(model) -> dict:
    return jax_bridge.module_to_jax_tree(model)


def _q4_model() -> tm.LTXModel:
    """JAX quantize_dit_params on the dense tree, bridged: bf16 scales, as an
    MLX snapshot stores them."""
    qtree = jax.tree.map(np.asarray, jquant.quantize_dit_params(jax.tree.map(jnp.asarray, _jax_tree(_dense_model()))))
    model = tm.LTXModel(TCFG, device="cpu", dtype=torch.float32)
    jax_bridge.load_jax_params(model, qtree)
    for m in model.modules():
        if isinstance(m, QuantLinear):
            m.scales, m.biases = m.scales.bfloat16(), m.biases.bfloat16()
    return model


def _q4_all_model() -> tm.LTXModel:
    """Every linear packed, as MLX's ``nn.quantize`` leaves a community
    snapshot (top-level linears too): 4 bits, groups of 32 where they divide
    ``in``, else 16 (the 16-wide patchify), bf16 scales."""
    model = _dense_model()
    for name, m in list(model.named_modules()):
        if isinstance(m, Linear):
            q = quantize_linear(m, 32 if m.weight.shape[1] % 32 == 0 else 16, 4)
            q.scales, q.biases = q.scales.bfloat16(), q.biases.bfloat16()
            parent, _, child = name.rpartition(".")
            setattr(model.get_submodule(parent), child, q)
    return model


def _write(path, model, key_fn, metadata=None):
    jst.save_safetensors(path, {key_fn(k): _np(v) for k, v in model.state_dict().items()}, metadata)
    return path


def _assert_same_tree(ref: dict, ours: dict):
    """JAX loader output vs the port's module in the JAX layout, bit for bit."""
    ref = jax.tree.map(np.asarray, ref)
    assert jax.tree.structure(ref) == jax.tree.structure(ours)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        got = ours
        for k in path:
            got = got[k.key]
        assert got.shape == leaf.shape, path
        if leaf.dtype == np.uint32:
            assert got.dtype == np.uint32, path
            np.testing.assert_array_equal(got, leaf)
        else:
            np.testing.assert_array_equal(got, leaf.astype(np.float32))


# --- safetensors ---

def _tensors(rng):
    return {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "bf16": rng.normal(size=(7,)).astype(ml_dtypes.bfloat16),
        "u32": rng.integers(0, 2**32, size=(4, 3), dtype=np.uint32),
        "f16": rng.normal(size=(2, 2)).astype(np.float16),
        "f8": rng.normal(size=(6,)).astype(ml_dtypes.float8_e4m3fn),
        "i64": rng.integers(-9, 9, size=(3,)).astype(np.int64),
        "u8": rng.integers(0, 255, size=(5,)).astype(np.uint8),
        "empty": np.zeros((0, 4), np.float32),
    }


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).view(torch.uint32)
    return torch.from_numpy(a.copy())


def test_safetensors_files_are_byte_identical_and_read_both_ways(rng, tmp_path):
    arrays = _tensors(rng)
    meta = {"format": "mlx_video_tpu", "n": "3"}
    jst.save_safetensors(tmp_path / "jax.safetensors", arrays, meta)
    tst.save_safetensors(tmp_path / "port.safetensors", {k: _torch(v) for k, v in arrays.items()}, meta)
    assert (tmp_path / "jax.safetensors").read_bytes() == (tmp_path / "port.safetensors").read_bytes()

    with tst.SafetensorsReader(tmp_path / "jax.safetensors") as r, \
            jst.SafetensorsReader(tmp_path / "port.safetensors") as jr:
        assert r.keys() == jr.keys() == list(arrays) and r.metadata == jr.metadata == meta
        for k, a in arrays.items():
            got = r.get(k)
            assert tuple(got.shape) == a.shape == r.shape(k) == jr.get(k).shape
            assert got.dtype == (torch.int32 if k == "u32" else _torch(a).dtype) == r.dtype(k)
            assert torch.equal(got.reshape(-1).view(torch.uint8), _torch(a).reshape(-1).view(torch.uint8))
            np.testing.assert_array_equal(jr.get(k).view(np.uint8), a.view(np.uint8))
        assert r.dtype_name("u32") == "U32" and r.dtype_name("bf16") == "BF16"
    parsed = tst.parse_safetensors_bytes((tmp_path / "jax.safetensors").read_bytes())
    assert torch.equal(parsed["f32"], torch.from_numpy(arrays["f32"]))
    assert tst.scan_keys([tmp_path / "jax.safetensors", tmp_path / "missing"]) == set(arrays)
    assert tst.read_metadata(tmp_path / "port.safetensors") == meta


def test_safetensors_rejects_unsupported_dtype(tmp_path):
    with pytest.raises(ValueError, match="Unsupported dtype"):
        tst.save_safetensors(tmp_path / "x.safetensors", {"c": torch.zeros(2, dtype=torch.complex64)})


# --- DiT ---

@pytest.mark.parametrize("key", [
    "model.diffusion_model.transformer_blocks.3.attn1.to_out.0.weight",
    "model.diffusion_model.transformer_blocks.0.ff.net.0.proj.bias",
    "model.diffusion_model.adaln_single.emb.timestep_embedder.linear_1.weight",
    "model.diffusion_model.patchify_proj.weight",
    "model.diffusion_model.scale_shift_table",
    "model.diffusion_model.audio_patchify_proj.weight",
    "model.diffusion_model.video_embeddings_connector.x.weight",
    "model.diffusion_model.av_ca_video_scale_shift_adaln_single.linear.weight",
    "vae.decoder.conv_in.weight",
])
def test_key_mapping_matches_jax(key):
    sani = tweights.sanitize_pt_key(key)
    assert sani == jweights.sanitize_pt_key(key)
    if sani is None:
        return
    mapped = jweights.dit_tree_path(sani)
    want = None
    if mapped is not None:  # every model type's names: blocks, video, audio, av
        layer, path = mapped
        want = ".".join(path[:1] + ((str(layer),) if layer is not None else ()) + path[1:])
    assert tweights.dit_tree_path(sani) == want


@pytest.mark.parametrize("layout", ["pytorch", "mlx", "mlx_q4", "mlx_q4_all"])
def test_load_dit_params_matches_jax_loader(tmp_path, layout):
    model = {"mlx_q4": _q4_model, "mlx_q4_all": _q4_all_model}.get(layout, _dense_model)()
    path = _write(tmp_path / "dit.safetensors", model, _pt_key if layout == "pytorch" else _mlx_key)
    ref = jweights.load_dit_params(path, CFG, dtype=jnp.float32)
    ours = tweights.load_dit_params(path, TCFG, dtype=torch.float32, device="cpu")
    assert all(t.device.type == "cpu" for t in ours.state_dict().values())  # nothing left on meta
    n_quant = sum(isinstance(m, QuantLinear) for m in ours.modules())
    assert n_quant == sum(isinstance(m, QuantLinear) for m in model.modules())
    assert n_quant == {"mlx_q4": 10 * CFG.num_layers, "mlx_q4_all": 27}.get(layout, 0)
    if layout.startswith("mlx_q4"):
        assert ours.blocks[0].attn1.to_q.scales.dtype == torch.bfloat16  # scales keep their dtype
    _assert_same_tree(ref, _jax_tree(ours))


def test_fully_quantized_snapshot_runs_like_jax(tmp_path):
    """A snapshot whose top-level linears are packed too: the forward matches
    JAX within 5e-4 of the largest output (the DiT bar), and the pipeline
    runs it (it finds the model's device and dtype without a dense weight)."""
    path = _write(tmp_path / "dit.safetensors", _q4_all_model(), _mlx_key)
    ref_tree = jweights.load_dit_params(path, CFG, dtype=jnp.float32)
    ours = tweights.load_dit_params(path, TCFG, dtype=torch.float32, device="cpu")
    assert isinstance(ours.video.patchify_proj, QuantLinear) and ours.video.patchify_proj.group_size == 16
    rng = np.random.default_rng(6)
    tokens = rng.normal(size=(1, 32, CFG.in_channels)).astype(np.float32)
    context = rng.normal(size=(1, 6, CFG.caption_channels)).astype(np.float32)
    ts = np.full((1, 1), 0.6, np.float32)
    pos = create_position_grid(1, 2, 4, 4)
    ref, _ = jm.ltx_apply(ref_tree, CFG, video=jm.Modality(
        latent=jnp.asarray(tokens), timesteps=jnp.asarray(ts), context=jnp.asarray(context),
        positions=jnp.asarray(pos)))
    got, _ = tm.ltx_apply(ours, TCFG, tm.Modality(
        latent=torch.from_numpy(tokens), timesteps=torch.from_numpy(ts), context=torch.from_numpy(context),
        positions=torch.from_numpy(pos)))
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() <= 5e-4

    g = torch.Generator().manual_seed(0)
    dec_cfg = DecoderConfig(in_channels=16, base_channels=32, num_layers_per_block=1)
    models = ModelBundle(ours, TCFG, init_video_decoder(g, dec_cfg, device="cpu"), dec_cfg,
                         init_latent_upsampler(g, 16, 32, 1, device="cpu"))
    res = generate_video(models, TextConditioning(torch.from_numpy(context)), height=64, width=64, num_frames=9,
                         stage1_steps=1, stage2_steps=1, decode_latents_only=True, dtype=torch.float32)
    assert res.latents.shape == (1, 16, 2, 2, 2) and np.isfinite(res.latents).all()


def test_load_dit_params_in_bf16_casts_floats_only(tmp_path):
    path = _write(tmp_path / "dit.safetensors", _q4_model(), _mlx_key)
    ours = tweights.load_dit_params(path, TCFG, dtype=torch.bfloat16, device="cpu")
    assert ours.video.patchify_proj.weight.dtype == torch.bfloat16
    assert ours.blocks[1].ff.proj_in.quant_weight.dtype == torch.int32
    ref = jweights.load_dit_params(path, CFG, dtype=jnp.float32)  # fp32 file values, rounded once
    np.testing.assert_array_equal(
        ours.video.patchify_proj.weight.float().numpy(),
        np.asarray(ref["video"]["patchify_proj"]["weight"]).T.astype(ml_dtypes.bfloat16).astype(np.float32),
    )


def test_native_files_match_jax_both_ways(tmp_path):
    """JAX save_dit_params -> port loader; port save_dit_params -> the same
    bytes as JAX's writer on the same (quantized) parameters."""
    model = _q4_model()
    tree = _jax_tree(model)
    for m in model.modules():  # native files keep the stored (here fp32) scales
        if isinstance(m, QuantLinear):
            m.scales, m.biases = m.scales.float(), m.biases.float()
    tree = _jax_tree(model)
    jweights.save_dit_params(tmp_path / "jax.safetensors", tree, metadata={"note": "x"})
    tweights.save_dit_params(tmp_path / "port.safetensors", model, metadata={"note": "x"})
    assert (tmp_path / "jax.safetensors").read_bytes() == (tmp_path / "port.safetensors").read_bytes()
    ours = tweights.load_dit_params(tmp_path / "jax.safetensors", TCFG, dtype=torch.float32, device="cpu")
    _assert_same_tree(jweights.load_native_params(tmp_path / "jax.safetensors"), _jax_tree(ours))


def test_unified_bundle_loads_transformer_and_decoder(tmp_path):
    model = _dense_model()
    snap = tmp_path / "snap"
    (snap / "vae").mkdir(parents=True)
    decoder = _decoder_checkpoint(snap / "vae" / "diffusion_pytorch_model.safetensors", "vae.decoder.")
    build_unified_bundle(tmp_path / "model.safetensors", _jax_tree(model), model_path=snap, include_audio=False)
    assert tloading.unified_bundle_file(tmp_path) == tmp_path / "model.safetensors"
    ours = tweights.load_native_params(tmp_path / "model.safetensors", TCFG, dtype=torch.float32,
                                       device="cpu", prefix="transformer.")
    _assert_same_tree(jweights.load_native_params(tmp_path / "model.safetensors", prefix="transformer."),
                      _jax_tree(ours))
    got = VideoDecoder(DecoderConfig(**DEC_KW))
    assert tvae.load_video_decoder_weights(tmp_path / "model.safetensors", got) == len(decoder.state_dict())
    _assert_decoders_equal(decoder, got)


def test_load_dit_params_is_strict(tmp_path):
    state = {_mlx_key(k): _np(v) for k, v in _q4_model().state_dict().items()}
    missing = dict(state)
    del missing["transformer_blocks.1.attn2.to_v.biases"]
    del missing["patchify_proj.bias"]
    jst.save_safetensors(tmp_path / "missing.safetensors", missing)
    with pytest.raises(ValueError, match="Missing 2 parameters"):
        tweights.load_dit_params(tmp_path / "missing.safetensors", TCFG, dtype=torch.float32, device="cpu")
    bad = dict(state)
    for i in range(CFG.num_layers):
        key = f"transformer_blocks.{i}.ff.proj_in.scales"
        bad[key] = np.concatenate([bad[key]] * 2, axis=1)[:, :3]  # 3 groups do not divide in = 128
    jst.save_safetensors(tmp_path / "bad.safetensors", bad)
    with pytest.raises(ValueError, match="Inconsistent quantized shapes"):
        jweights.load_dit_params(tmp_path / "bad.safetensors", CFG, dtype=jnp.float32)
    with pytest.raises(ValueError, match="Inconsistent quantized shapes"):
        tweights.load_dit_params(tmp_path / "bad.safetensors", TCFG, dtype=torch.float32, device="cpu")
    wrong = dict(state)
    wrong["patchify_proj.weight"] = wrong["patchify_proj.weight"][:, :8]
    jst.save_safetensors(tmp_path / "wrong.safetensors", wrong)
    with pytest.raises(ValueError, match="Shape mismatch"):
        tweights.load_dit_params(tmp_path / "wrong.safetensors", TCFG, dtype=torch.float32, device="cpu")


# --- VAE decoder and upsampler ---

def _decoder_key(name: str) -> str:
    """Port decoder name -> checkpoint key (the inverse of _remap_decoder_key),
    with the CausalConv ``.conv`` nesting of real checkpoints."""
    if name == "latents_mean":
        return "per_channel_statistics.mean-of-means"
    if name == "latents_std":
        return "per_channel_statistics.std-of-means"
    parts = name.split(".")
    if parts[0] == "up_blocks":
        i, rest = int(parts[1]), parts[2:]
        if i == 0:
            parts = ["mid_block"] + (["resnets"] + rest[1:] if rest[0] == "res_blocks" else rest)
        elif i % 2 == 0:
            parts = ["up_blocks", str(i // 2 - 1)] + (["resnets"] + rest[1:] if rest[0] == "res_blocks" else rest)
        else:
            parts = ["up_blocks", str(i // 2), "upsamplers", "0"] + rest
    if len(parts) >= 2 and parts[-2] in ("conv1", "conv2", "conv_in", "conv_out"):
        parts = parts[:-1] + ["conv", parts[-1]]
    return ".".join(parts)


def _decoder_checkpoint(path, prefix="decoder."):
    decoder = init_video_decoder(torch.Generator().manual_seed(2), DecoderConfig(**DEC_KW), device="cpu")
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for t in decoder.state_dict().values():
            t.add_(0.1 * torch.randn(t.shape, generator=g))
    tensors = {}
    for name, t in decoder.state_dict().items():
        key = _decoder_key(name)
        tensors[key if key.startswith("per_channel") else prefix + key] = _np(t)
    jst.save_safetensors(path, tensors)
    return decoder


def _assert_decoders_equal(a, b):
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name


def test_decoder_loader_matches_jax(tmp_path):
    path = tmp_path / "vae.safetensors"
    ref_module = _decoder_checkpoint(path)
    params = jax_init_decoder(jax.random.key(0), JaxDecoderConfig(**DEC_KW), dtype=jnp.float32)
    n_ref = jvae.load_video_decoder_weights(path, params, dtype=jnp.float32)
    ours = VideoDecoder(DecoderConfig(**DEC_KW))
    assert tvae.load_video_decoder_weights(path, ours) == n_ref == len(ours.state_dict())
    _assert_same_tree(params, _jax_tree(ours))
    _assert_decoders_equal(ref_module, ours)


@pytest.mark.parametrize("bundled", [False, True])
def test_upsampler_loader_matches_jax(tmp_path, bundled):
    ups = init_latent_upsampler(torch.Generator().manual_seed(4), 16, 32, 2, device="cpu")
    with torch.no_grad():
        for t in ups.state_dict().values():
            t.add_(0.1)
    prefix = "upsampler." if bundled else ""
    path = tmp_path / "ups.safetensors"
    jst.save_safetensors(path, {prefix + k: _np(v) for k, v in ups.state_dict().items()})
    params = jax_init_upsampler(jax.random.key(0), in_channels=16, mid_channels=32, num_blocks=2)
    n_ref = jvae.load_upsampler_weights(path, params, dtype=jnp.float32)
    ours = LatentUpsampler(16, 32, 2)
    assert tvae.load_upsampler_weights(path, ours) == n_ref == len(ups.state_dict())
    _assert_same_tree(params, _jax_tree(ours))


def test_loaders_raise_on_shape_mismatch(tmp_path):
    ups = init_latent_upsampler(torch.Generator().manual_seed(4), 16, 32, 2, device="cpu")
    jst.save_safetensors(tmp_path / "ups.safetensors", {"final_conv.bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="Shape mismatch"):
        tvae.load_upsampler_weights(tmp_path / "ups.safetensors", ups)


# --- snapshot resolution and bundle helpers ---

def test_snapshot_resolution_matches_jax(tmp_path):
    for name in ("ltx-2-19b-distilled-4bit-mlx.safetensors", "ltx-2-19b-dev.safetensors"):
        jst.save_safetensors(tmp_path / name, {"x": np.zeros(1, np.float32)})
    for kind, hint in [("distilled", "4bit"), ("distilled", None), ("dev", None), ("dev", "8bit")]:
        try:
            want = jloading.resolve_transformer_file(tmp_path, kind, hint)
        except FileNotFoundError:
            with pytest.raises(FileNotFoundError):
                tloading.resolve_transformer_file(tmp_path, kind, hint)
            continue
        assert tloading.resolve_transformer_file(tmp_path, kind, hint) == want
    assert tloading.resolve_vae_file(tmp_path, "4bit") == jloading.resolve_vae_file(tmp_path, "4bit")
    with pytest.raises(FileNotFoundError):
        tloading.resolve_vae_file(tmp_path / "empty")
    assert tloading.unified_bundle_file(tmp_path) is None
    for repo in ("AITRADER/ltx2-distilled-4bit-mlx", "x-q8", "Lightricks/LTX-2", "/w/int4"):
        assert tloading.bits_hint_for(repo) == jloading.bits_hint_for(repo)


def test_read_quantization_metadata(tmp_path):
    assert tloading.read_quantization_metadata(tmp_path) is None
    (tmp_path / "quantization.json").write_text(json.dumps({"bits": 4, "group_size": 64}))
    assert tloading.read_quantization_metadata(tmp_path / "sub") == {"bits": 4, "group_size": 64}


@pytest.mark.parametrize("kwargs, joint", [
    ({"audio": True, "pipeline": "keyframe"}, False), ({"audio": True}, False),
    ({"audio": True, "pipeline": "dev"}, True), ({"audio": True, "audio_mode": "joint", "stage2_path": "s2"}, True),
])
def test_load_model_bundle_loads_the_audio_parts(tmp_path, monkeypatch, kwargs, joint):
    """With audio: the audio VAE decoder and the vocoder from their folders;
    joint audio (the dev default, or asked for) an AudioVideo transformer
    (and stage-2 one), separate audio a VideoOnly one plus an AudioOnly one
    from the file resolve_audio_transformer_file finds."""
    from mlx_video_tpu_torch.models.ltx.audio_vae import audio_vae as taudio
    from mlx_video_tpu_torch.models.ltx.audio_vae import vocoder as tvoc

    loads = []
    monkeypatch.setattr(tloading, "load_dit_params", lambda paths, cfg, **kw: loads.append((paths[0], cfg)) or cfg)
    monkeypatch.setattr(tloading, "DecoderConfig", lambda: DecoderConfig(**DEC_KW))
    monkeypatch.setattr(tloading.vae_weights, "load_video_decoder_weights", lambda *a: None)
    monkeypatch.setattr(tloading, "AudioVAEConfig", lambda: taudio.AudioVAEConfig(ch=8))
    monkeypatch.setattr(tloading, "VocoderConfig", lambda: tvoc.VocoderConfig(upsample_initial_channel=32))
    filled = []
    monkeypatch.setattr(tloading.vae_weights, "load_audio_vae_weights", lambda path, m: filled.append(path))
    monkeypatch.setattr(tloading.vae_weights, "load_vocoder_weights", lambda path, m: filled.append(path))
    for snap in (tmp_path, tmp_path / "s2"):
        for name in ("ltx-2-19b-distilled.safetensors", "ltx-2-19b-dev.safetensors"):
            snap.mkdir(exist_ok=True)
            (snap / name).write_bytes(b"")
    for part in ("audio_vae", "vocoder"):
        (tmp_path / part).mkdir()
        (tmp_path / part / "diffusion_pytorch_model.safetensors").write_bytes(b"")
    kwargs = {**kwargs, "stage2_path": tmp_path / kwargs["stage2_path"]} if "stage2_path" in kwargs else kwargs
    bundle = tloading.load_model_bundle(tmp_path, device="cpu", **kwargs)
    assert filled == [tmp_path / p / "diffusion_pytorch_model.safetensors" for p in ("audio_vae", "vocoder")]
    assert isinstance(bundle.audio_decoder, taudio.AudioDecoder) and isinstance(bundle.vocoder, tvoc.Vocoder)
    types = [cfg.model_type.name for _, cfg in loads]
    if joint:
        assert types == ["AudioVideo"] * (2 if "stage2_path" in kwargs else 1) and bundle.audio_transformer is None
    else:
        assert types == ["VideoOnly", "AudioOnly"] and bundle.audio_transformer_config.model_type.name == "AudioOnly"
        assert loads[1][0] == tmp_path / "ltx-2-19b-dev.safetensors"  # the dev weights first


def test_quantize_models_quantizes_in_place_and_refuses_int8_modes():
    """In place: --quantize-bits, W8A8 (Int8Linears), W4A8 (int8 scales on
    the quantized linears); the two int8 modes together are refused."""
    from mlx_video_tpu_torch.ops.linear import Int8Linear

    models = ModelBundle(_dense_model(), TCFG, None, None)
    with pytest.raises(ValueError, match="exclusive"):
        tloading.quantize_models(models, w8a8=True, w4a8=True)
    tloading.quantize_models(models, quantize_bits=8)
    assert models.transformer.blocks[0].attn1.to_q.bits == 8
    tloading.quantize_models(models, w4a8=True)
    assert models.transformer.blocks[0].attn1.to_q.int8_scale.shape == (models.transformer.blocks[0].attn1.to_q.out_features,)
    models = ModelBundle(_dense_model(), TCFG, None, None)
    tloading.quantize_models(models, w8a8=True)
    assert isinstance(models.transformer.blocks[0].ff.proj_out, Int8Linear)
    assert tloading.model_config_for().num_layers == 48
