"""The port's single-device memory plan (io/staging.py, utils/device.py,
``generate_video(low_memory=, aux_int8_staging=, overlap_staging=,
aux_park_device=, keep_transformer=)``, the generate CLI's four flags and
``serve --aux-park``) against the JAX package, on the CPU, at narrow width
(the 2-layer split-RoPE DiT, the narrow decoder and upsampler, fp32).

- The codec: the port's codes equal JAX's ``_quantize_np`` codes on shared
  weights given in the port's layouts (a linear, a 3-D conv); every parked
  module's dequantized tensors equal JAX's ``unpark_int8`` of its JAX tree,
  bit for bit, stacked blocks included (``_MIN_QUANT_SIZE`` lowered in both
  packages, as tests/test_staging.py lowers it, so the narrow tensors are
  quantized); then JAX's own codec cases, one for one.
- ``generate_video``: a tiny fp32 ``low_memory`` run with and without the
  int8 codec in both packages on JAX's draws; the port's bitwise cases
  (bf16 staging against no staging, overlap on against off, the card park
  against the host park, two ``keep_transformer`` runs); the bundle's state
  after a run; JAX's messages.
- The CLI forwards the four flags; ``--optimize-layouts`` prints its note.
- The server: a served ``--aux-park`` request from prompts against JAX's
  served ``aux_park`` request; the second request bitwise the first; a
  LoRA request's parks back on the service's bundle.

Bars, each with its reason:
- codes, scales, dequantized tensors: equal (the same fp32 operations:
  a correctly rounded quotient, round half to even);
- round trip: |x - x'| <= group amax / 254 (1.001 of it), half a code step,
  JAX's bound; group scales against per-channel ones: JAX's median bar;
- against JAX: >= 35 dB per latent and RGB frame, the repo's pipeline gate;
- int8 staging against bf16 staging: > 35 dB over the video, JAX's bar
  (tests/test_staging.py);
- staging without the codec, overlap, the park's place, repeated runs:
  bitwise (the same values reach the same operations).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_conditioned import H, W, _adapter, _bundles, _dit, _JaxDraws, _run_both, parts  # noqa: F401
from test_torch_port_dev import psnr
from torch import nn

from mlx_video_tpu.cli import serve as jserve
from mlx_video_tpu.io import staging as jstaging
from mlx_video_tpu.pipelines import generate as jgen
from mlx_video_tpu_torch import loading
from mlx_video_tpu_torch.cli import generate as tcli
from mlx_video_tpu_torch.cli import serve as tserve
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.io import staging
from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import AudioVAEConfig, init_audio_decoder
from mlx_video_tpu_torch.models.ltx.audio_vae.vocoder import VocoderConfig, init_vocoder
from mlx_video_tpu_torch.models.ltx.video_vae.conv import Conv3d
from mlx_video_tpu_torch.ops.linear import Linear
from mlx_video_tpu_torch.pipelines import generate as tgen
from mlx_video_tpu_torch.utils import device as tdevice

SMALL = dict(height=64, width=64, num_frames=9, stage1_steps=1, stage2_steps=1, seed=5, tiling="none",
             dtype=torch.float32)


@pytest.fixture
def small_codec(monkeypatch):
    """Both packages quantize tensors of 256 elements and up."""
    monkeypatch.setattr(staging, "_MIN_QUANT_SIZE", 256)
    monkeypatch.setattr(jstaging, "_MIN_QUANT_SIZE", 256)


def _jax_host():
    return jax.devices("cpu")[0]


def _seeded(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _codes(parked) -> list:
    return [s.payload for s in parked.slots if isinstance(s.payload, staging.Codes)]


# --- the codec ---

@pytest.mark.parametrize("kind", ["linear", "conv3d"])
def test_codes_equal_jax_codes_on_shared_weights(kind):
    """The port's layouts ((out, in) and (O, I, kd, kh, kw)) viewed in JAX's
    ((in, out) and (kd, kh, kw, I, O)): the codes and scales of the large
    weight are JAX's, the bias rides raw."""
    if kind == "linear":
        module = Linear(600, 200, bias=True)
        jax_weight = _seeded((600, 200), 1, 0.5)  # (in, out)
        module.weight.data = torch.from_numpy(np.ascontiguousarray(jax_weight.T))
    else:
        module = Conv3d(48, 64, 3)
        jax_weight = _seeded((3, 3, 3, 48, 64), 2, 0.1)  # (kd, kh, kw, I, O); 1296 rows: the last group padded
        module.weight.data = torch.from_numpy(np.ascontiguousarray(jax_weight.transpose(4, 3, 0, 1, 2)))
    module.bias.data = torch.from_numpy(_seeded((module.bias.shape[0],), 3))
    parked = staging.park_int8(module, "cpu")
    (codes,) = _codes(parked)
    ref = jstaging._quantize_np(jax_weight)
    assert codes.q.dtype == torch.int8 and tuple(codes.q.shape) == jax_weight.shape
    assert torch.equal(codes.q, torch.from_numpy(ref["q"])) and torch.equal(codes.scale, torch.from_numpy(ref["scale"]))
    bias = [s.payload for s in parked.slots if s.paths == ("bias",)]
    assert bias and torch.equal(bias[0][0], module.bias.detach())


def _aux_modules():
    g = torch.Generator().manual_seed(9)
    from mlx_video_tpu_torch.models.ltx.upsampler import init_latent_upsampler
    from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, init_video_decoder

    dec = init_video_decoder(g, DecoderConfig(in_channels=16, base_channels=32, num_layers_per_block=2), device="cpu")
    return {
        "decoder": (dec, jax_bridge.module_to_jax_tree(dec)),
        "upsampler": (ups := init_latent_upsampler(g, 16, 32, 2, device="cpu"), jax_bridge.module_to_jax_tree(ups)),
        "audio_decoder": (ad := init_audio_decoder(g, AudioVAEConfig(ch=8), device="cpu", dtype=torch.float32),
                          jax_bridge.audio_decoder_to_jax_tree(ad)),
        "vocoder": (voc := init_vocoder(g, VocoderConfig(upsample_initial_channel=32), device="cpu",
                                        dtype=torch.float32), jax_bridge.vocoder_to_jax_tree(voc)),
    }


@pytest.mark.parametrize("name", ["decoder", "upsampler", "audio_decoder", "vocoder"])
def test_every_aux_module_dequantizes_to_jax_bits(small_codec, name):
    """The whole module, parked in the port and its JAX tree parked in JAX:
    as many quantized leaves, and the unparked tensors equal bit for bit
    (the decoder and upsampler with 2 blocks a stacked key, so their groups
    run across blocks as JAX's do; the vocoder's 1-D convs and transposed
    convs in their own layouts)."""
    module, tree = _aux_modules()[name]
    parked = staging.park_int8(module, "cpu")
    jparked = jstaging.park_int8(jax.tree.map(jnp.asarray, tree), _jax_host())
    n_jax = sum(jstaging._is_parked_leaf(leaf) for leaf in jax.tree.leaves(jparked, is_leaf=jstaging._is_parked_leaf))
    assert len(_codes(parked)) == n_jax > 0
    assert any(c.stacked for c in _codes(parked)) == (name in ("decoder", "upsampler"))
    back = staging.unpark_int8(parked, "cpu")
    jback = jstaging.unpark_int8(jparked, _jax_host())
    convert = {"audio_decoder": jax_bridge.audio_decoder_to_jax_tree, "vocoder": jax_bridge.vocoder_to_jax_tree}.get(
        name, jax_bridge.module_to_jax_tree)
    got, ref = jax.tree.leaves(convert(back)), jax.tree.leaves(jax.tree.map(np.asarray, jback))
    assert len(got) == len(ref) and all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert type(back) is type(module) and back is not module


class _Holder(nn.Module):
    def __init__(self, **tensors):
        super().__init__()
        for k, v in tensors.items():
            if v.is_floating_point():
                setattr(self, k, nn.Parameter(v, requires_grad=False))
            else:
                self.register_buffer(k, v)


def test_round_trip_error_bound(small_codec):
    """JAX's bound: half a code step of the element's own group."""
    w = torch.from_numpy(_seeded((64, 32, 64), 0, 3.0))
    parked = staging.park_int8(_Holder(weight=w), "cpu")
    assert staging.is_parked(parked)
    back = staging.unpark_int8(parked, "cpu").weight
    assert back.dtype == w.dtype
    r = w.numpy().reshape(-1, 64)
    group_amax = np.abs(r.reshape(-1, staging._GROUP_SIZE, 64)).max(axis=1)
    bound = np.repeat(group_amax, staging._GROUP_SIZE, axis=0).reshape(w.shape) / 254.0
    assert np.max(np.abs(w.numpy() - back.numpy()) / (bound + 1e-12)) <= 1.001


def test_group_scales_beat_per_channel(small_codec):
    """One outlier row a channel costs its own group only."""
    w = _seeded((4096, 8), 2, 0.01)
    w[0, :] = 50.0
    back = staging.unpark_int8(staging.park_int8(_Holder(w=torch.from_numpy(w)), "cpu"), "cpu").w.numpy()
    bulk = slice(staging._GROUP_SIZE, None)
    assert np.median(np.abs(w[bulk] - back[bulk]) / (np.abs(w[bulk]) + 1e-12)) < 0.05


def test_small_and_int_tensors_pass_through_exact():
    module = _Holder(bias=torch.arange(8, dtype=torch.float32), norm=torch.ones(16, 4),
                     idx=torch.arange(6, dtype=torch.int32))
    parked = staging.park_int8(module, "cpu")
    assert not staging.is_parked(parked)
    back = staging.unpark_int8(parked, "cpu")
    for key, t in module.state_dict().items():
        assert torch.equal(back.state_dict()[key], t) and back.state_dict()[key].dtype == t.dtype


def test_bf16_dtype_restored(small_codec):
    w = (torch.from_numpy(_seeded((32, 2048), 1, 0.1))).to(torch.bfloat16)
    back = staging.unpark_int8(staging.park_int8(_Holder(w=w), "cpu"), "cpu")
    assert back.w.dtype == torch.bfloat16


def test_repark_passes_through_without_quantizing(small_codec, monkeypatch):
    """A parked module, and a module unparked from it, park to the same
    codes; nothing is quantized again."""
    p1 = staging.park_int8(_Holder(w=torch.from_numpy(_seeded((64, 2048), 4))), "cpu")
    monkeypatch.setattr(staging, "_quantize", lambda w: pytest.fail("quantized again"))
    p2 = staging.park_int8(p1, "cpu")
    p3 = staging.park_int8(staging.unpark_int8(p1, "cpu"), "cpu")
    assert staging.is_parked(p2) and staging.is_parked(p3)
    for p in (p2, p3):
        assert torch.equal(_codes(p)[0].q, _codes(p1)[0].q) and torch.equal(_codes(p)[0].scale, _codes(p1)[0].scale)
    assert torch.equal(staging.unpark_int8(p2, "cpu").w, staging.unpark_int8(p1, "cpu").w)


def test_unpark_begin_finish_matches_unpark(small_codec):
    parked = staging.park_int8(_Holder(w=torch.from_numpy(_seeded((256, 512), 5)), bias=torch.ones(4)), "cpu")
    out = staging.unpark_finish(staging.unpark_begin(parked, "cpu"))
    ref = staging.unpark_int8(parked, "cpu")
    assert torch.equal(out.w, ref.w) and torch.equal(out.bias, ref.bias)


def test_none_passes_through():
    assert staging.park_int8(None, "cpu") is None and staging.unpark_int8(None, "cpu") is None
    assert staging.unpark_finish(staging.unpark_begin(None, "cpu")) is None
    tdevice.drain_device_queue("cpu")  # the fence is a no-op on the CPU


# --- generate_video ---

@pytest.mark.parametrize("int8", [False, True])
def test_low_memory_generate_matches_jax(monkeypatch, tmp_path, parts, small_codec, int8):  # noqa: F811
    """A tiny fp32 low_memory run, with and without the codec, in both
    packages on shared weights and JAX's draws; the bundles' transformers
    are freed in both."""
    port, jax_bundle = _bundles(parts, _dit(40))
    got, lat, rgb = _run_both(monkeypatch, tmp_path, port, jax_bundle, parts, low_memory=True,
                              aux_int8_staging=int8)
    assert lat >= 35.0 and rgb >= 35.0, (lat, rgb)
    assert port.transformer is None and jax_bundle.transformer_params is None
    assert isinstance(port.upsampler, staging.ParkedModule) and staging.is_parked(port.upsampler) == int8


def _port_run(bundle, parts, **kw):  # noqa: F811
    return tgen.generate_video(bundle, tgen.TextConditioning(parts["ctx"]), **{**SMALL, **kw})


def _fresh(parts, seed: int = 41):  # noqa: F811
    return _bundles(parts, _dit(seed))[0]


def test_int8_staging_drift_against_bf16_staging(parts, small_codec):  # noqa: F811
    """JAX's e2e bar for the codec: the decoded frames of an int8-staged
    run against the plain staged run."""
    ref = _port_run(_fresh(parts), parts, low_memory=True)
    q = _port_run(_fresh(parts), parts, low_memory=True, aux_int8_staging=True)
    assert np.all(np.isfinite(q.video)) and not np.array_equal(q.video, ref.video)
    mse = float(np.mean((q.video - ref.video) ** 2))
    assert 10 * np.log10(4.0 / max(mse, 1e-12)) > 35.0


def test_staging_without_the_codec_is_bitwise_a_plain_run(parts):  # noqa: F811
    ref = _port_run(_fresh(parts), parts)
    got = _port_run(_fresh(parts), parts, low_memory=True)
    assert np.array_equal(got.latents, ref.latents) and np.array_equal(got.video, ref.video)


@pytest.mark.parametrize("int8", [False, True])
def test_overlap_on_and_off_are_bitwise_equal(parts, small_codec, int8):  # noqa: F811
    a = _port_run(_fresh(parts), parts, low_memory=True, aux_int8_staging=int8, overlap_staging=True)
    b = _port_run(_fresh(parts), parts, low_memory=True, aux_int8_staging=int8, overlap_staging=False)
    assert np.array_equal(a.video, b.video) and np.array_equal(a.latents, b.latents)


def test_card_park_equals_host_park(parts, small_codec, monkeypatch):  # noqa: F811
    """aux_park_device parks on the transformer's device (the CPU here); the
    environment switch selects it too."""
    host = _fresh(parts)
    a = _port_run(host, parts, low_memory=True, aux_int8_staging=True, aux_park_device=False)
    monkeypatch.setenv("MLX_VIDEO_AUX_PARK", "device")
    dev = _fresh(parts)
    b = _port_run(dev, parts, low_memory=True, aux_int8_staging=True)
    assert np.array_equal(a.video, b.video)
    assert dev.upsampler.devices() == host.upsampler.devices() == {torch.device("cpu")}


def test_two_keep_transformer_runs_reuse_the_bundle(parts, small_codec):  # noqa: F811
    """The serving pattern: the aux modules stay parked between runs and
    the transformer stays; the second video equals the first."""
    bundle = _fresh(parts)
    dit = bundle.transformer
    kw = dict(low_memory=True, aux_int8_staging=True, keep_transformer=True)
    r1 = _port_run(bundle, parts, **kw)
    parks = [getattr(bundle, a) for a in ("vae_decoder", "upsampler")]
    assert all(staging.is_parked(p) for p in parks) and bundle.transformer is dit
    r2 = _port_run(bundle, parts, **kw)
    assert np.array_equal(r1.video, r2.video) and np.array_equal(r1.latents, r2.latents)
    assert all(staging.is_parked(getattr(bundle, a)) for a in ("vae_decoder", "upsampler"))
    assert all(getattr(bundle, a).skeleton is p.skeleton for a, p in zip(("vae_decoder", "upsampler"), parks))


def test_bundle_state_after_low_memory_and_restore(parts, small_codec):  # noqa: F811
    """Without keep_transformer every transformer is dropped (a run then
    asks for a reload); a plain run on the parked bundle brings every
    parked module back, the codes' values in it."""
    bundle = dataclasses.replace(_fresh(parts), stage2_transformer=_dit(42))
    _port_run(bundle, parts, low_memory=True, aux_int8_staging=True)
    assert bundle.transformer is None and bundle.stage2_transformer is None and bundle.audio_transformer is None
    assert staging.is_parked(bundle.upsampler) and isinstance(bundle.vae_decoder, nn.Module)
    with pytest.raises(ValueError, match="load the bundle again"):
        _port_run(bundle, parts)
    bundle.transformer = _dit(41)
    bundle.vae_decoder = staging.park_int8(bundle.vae_decoder, "cpu")
    assert isinstance(bundle.latents_mean, torch.Tensor)  # read from the park
    _port_run(bundle, parts)
    assert all(isinstance(getattr(bundle, a), nn.Module) for a in ("vae_decoder", "upsampler", "vae_encoder"))
    assert torch.equal(bundle.upsampler.initial_conv.weight,
                       staging.unpark_int8(staging.park_int8(bundle.upsampler, "cpu"), "cpu").initial_conv.weight)


def test_messages_are_jax_messages(parts):  # noqa: F811
    port, jax_bundle = _bundles(parts, _dit(43))
    jtext = jgen.TextConditioning(jnp.asarray(parts["ctx"].numpy()))
    kw = dict(height=64, width=64, num_frames=9, stage1_steps=1, stage2_steps=1)
    for bad in (dict(aux_int8_staging=True), dict(low_memory=True, mesh=object())):
        with pytest.raises(ValueError) as theirs:
            jgen.generate_video(jax_bundle, jtext, decode_latents_only=True, dtype=jnp.float32, **kw, **bad)
        with pytest.raises(ValueError) as ours:
            _port_run(port, parts, decode_latents_only=True, **bad)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError) as theirs:
        jserve.GenerationService(None, aux_park=True, mesh=object())
    with pytest.raises(ValueError) as ours:
        tserve.GenerationService(None, aux_park=True, mesh=object())
    assert str(ours.value) == str(theirs.value)


# --- the CLI ---

@pytest.mark.parametrize("flags, want", [
    ((), dict(low_memory=False, aux_int8_staging=False, overlap_staging=None, aux_park_device=None)),
    (("--low-memory", "--aux-stage-int8", "--aux-park-device", "--no-overlap-staging"),
     dict(low_memory=True, aux_int8_staging=True, overlap_staging=False, aux_park_device=True)),
])
def test_cli_forwards_the_memory_flags(monkeypatch, tmp_path, flags, want):
    """As mlx_video_tpu/cli/generate.py forwards them, with the prompt; with
    --low-memory the loader leaves the aux modules on the host."""
    from test_torch_port_cli import _tiny_bundle

    emb = tmp_path / "emb.safetensors"
    from mlx_video_tpu_torch.io.safetensors import save_safetensors

    save_safetensors(emb, {"video_prompt_embeds": torch.zeros(8, 48)})
    loads, runs = [], []
    monkeypatch.setattr(loading, "load_model_bundle", lambda *a, **kw: loads.append(kw) or _tiny_bundle())
    monkeypatch.setattr(tgen, "generate_video", lambda *a, **kw: runs.append(kw) or tgen.GenerateResult(None, None))
    tcli.main(["--prompt", "a cat", "--checkpoint-path", str(tmp_path), "--embeddings", str(emb), "--device", "cpu",
               *flags])
    (load,), (run,) = loads, runs
    assert {k: run[k] for k in want} == want and run["prompt"] == "a cat"
    assert load["aux_device"] == ("cpu" if want["low_memory"] else None)  # the plan's modules load to the host


def test_optimize_layouts_prints_its_note(monkeypatch, tmp_path, capsys):
    from test_torch_port_cli import _run_main, _tiny_bundle

    emb = tmp_path / "emb.safetensors"
    from mlx_video_tpu_torch.io.safetensors import save_safetensors

    save_safetensors(emb, {"video_prompt_embeds": torch.zeros(8, 48)})
    assert _run_main(monkeypatch, tmp_path, emb, _tiny_bundle(), ["--optimize-layouts", "--low-memory"]).exists()
    notes = [line for line in capsys.readouterr().out.splitlines() if line.startswith("note:")]
    assert notes == ["note: --optimize-layouts has no effect on the GPU: the port's weights are already in the "
                     "layouts its kernels read (ignored)"]


# --- the server ---

class _Encoder:
    """The same deterministic embeddings a prompt, as torch or JAX arrays."""

    def __init__(self, jax_side: bool = False):
        self.jax_side = jax_side

    def encode(self, prompt):
        emb = np.random.default_rng(sum(map(ord, prompt))).normal(size=(1, 8, 48)).astype(np.float32)
        return (jnp.asarray(emb) if self.jax_side else torch.from_numpy(emb)), None


class _Runs:
    """Keeps each generate_video result of a package."""

    def __init__(self, monkeypatch, module):
        self.results, inner = [], module.generate_video

        def wrapped(*a, **kw):
            self.results.append(inner(*a, **kw))
            return self.results[-1]

        monkeypatch.setattr(module, "generate_video", wrapped)


def _draws(seed: int) -> _JaxDraws:
    keys = jax.random.split(jax.random.key(seed), 8)
    return _JaxDraws([jax.random.normal(keys[0], (1, 16, 2, 2, 2), dtype=jnp.float32),
                      jax.random.normal(keys[1], (1, 16, 2, 4, 4), dtype=jnp.float32),
                      np.transpose(np.asarray(jax.random.normal(keys[2], (1, 2, 4, 4, 16), dtype=jnp.float32)),
                                   (0, 4, 1, 2, 3))])


def test_aux_park_server_matches_jax(parts, tmp_path, monkeypatch, small_codec):  # noqa: F811
    """A request from a prompt through each server with aux_park (JAX's
    first, its draws then handed to the port): >= 35 dB per latent and RGB
    frame. The port's second request is bitwise its first, the aux modules
    stay parked on the card between requests, and a LoRA request's parks go
    back to the service's bundle."""
    lora_dir = tmp_path / "adapters"
    lora_dir.mkdir()
    _adapter(lora_dir / "style.safetensors", 61, rank=4)
    req = {"prompt": "a cat on a mat", "height": H, "width": W, "num_frames": 9, "stage1_steps": 2,
           "stage2_steps": 1, "tiling": "none", "seed": 3}
    port, jax_bundle = _bundles(parts, _dit(44))
    jsvc = jserve.GenerationService(jax_bundle, text_encoder=_Encoder(jax_side=True), output_dir=tmp_path / "jax",
                                    dtype=jnp.float32, aux_park=True)
    tsvc = tserve.GenerationService(port, text_encoder=_Encoder(), output_dir=tmp_path / "port",
                                    dtype=torch.float32, aux_park=True, lora_dir=lora_dir)
    jruns, truns = _Runs(monkeypatch, jgen), _Runs(monkeypatch, tgen)
    assert jsvc.generate(dict(req))["requests_served"] == 1
    assert jstaging.is_parked(jax_bundle.vae_decoder_params)
    for _ in range(2):
        monkeypatch.setattr(torch, "randn", _draws(3))
        assert tsvc.generate(dict(req))["requests_served"] in (1, 2)
        assert all(staging.is_parked(getattr(port, a)) for a in ("vae_decoder", "upsampler"))
        assert port.transformer is not None
    (ref,), (got, again) = jruns.results, truns.results
    assert np.array_equal(got.video, again.video) and np.array_equal(got.latents, again.latents)
    peak = float(np.abs(ref.latents).max())
    assert min(psnr(got.latents[:, :, i], ref.latents[:, :, i], peak) for i in range(2)) >= 35.0
    assert min(psnr(got.video[:, :, i], ref.video[:, :, i], 2.0) for i in range(9)) >= 35.0
    parks = {a: getattr(port, a) for a in ("vae_decoder", "upsampler")}
    monkeypatch.setattr(torch, "randn", _draws(3))
    tsvc.generate(dict(req, lora="style.safetensors"))
    assert all(staging.is_parked(getattr(port, a)) and getattr(port, a).skeleton is parks[a].skeleton
               for a in parks)
    assert not np.array_equal(truns.results[-1].latents, got.latents)
