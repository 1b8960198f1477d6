"""The port's LoRA merge and its conditioned distilled pipelines against the
JAX package, on the CPU, at narrow width (a 2-layer DiT, a narrow VAE, fp32).

- ``merge_lora_into_params``: the merged weights against the JAX merge on
  shared weights and adapter files, fp32 and bf16 bases, applied and skipped
  counts, a quantized base, the input left unchanged and the unwritten
  tensors shared.
- ``generate_video``, whole, in both packages on shared weights: an image in
  replace mode at both stages, keyframes in guide mode, a video conditioning
  on a merged adapter (IC-LoRA), a separate stage-2 model under stage-2 CFG.
  JAX's own draws (``jax.random.normal`` of keys 0, 1 and 2 of the split
  seed: stage 1, stage 2, decode) are handed to the port by standing in for
  ``torch.randn``, which also checks that the port draws the same shapes in
  the same order.
- ``num_videos``, streaming decode, ``select_tiling(..., stream)``, the device
  blend of the tiled decode and the loader's stage-2 file and pipelines.

Bars, each with its reason:
- merged weights: fp32 within one ulp of JAX's (the same fp32 product and
  sum); bf16 at most 1e-4 of the elements differ, each by one bf16 ulp (a
  product rounded once more the other way); both read bitwise equal here;
- composed pipelines: per-frame latent and RGB PSNR >= 35 dB, the repo's
  pipeline gate (tests/test_torch_port_pipeline.py);
- batched videos against single runs: JAX's own test's tolerance, rtol 2e-4
  and atol 1e-5 (tests/test_generate.py, batched matmuls reduce in another
  order);
- streamed frames and the device blend: the same fp32 operations in the same
  order, so equal (the device blend to 1e-6).
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_dev import DEC_KW, ENC_KW, _encoder, _jax_tree, _write_png, psnr

from mlx_video_tpu import lora as jlora
from mlx_video_tpu.config import LTXModelType, LTXRopeType, VideoVAEConfig as JaxVAEConfig, tiny_test_config
from mlx_video_tpu.io.safetensors import save_safetensors
from mlx_video_tpu.models.ltx.video_vae.decoder import DecoderConfig as JaxDecoderConfig
from mlx_video_tpu.ops import quant as jquant
from mlx_video_tpu.pipelines import generate as jgen
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch import loading as tloading
from mlx_video_tpu_torch import lora as tlora
from mlx_video_tpu_torch.io import jax_bridge, media
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.models.ltx import upsampler as tups
from mlx_video_tpu_torch.models.ltx.video_vae import decoder as tdec
from mlx_video_tpu_torch.models.ltx.video_vae import tiling as ttiling
from mlx_video_tpu_torch.ops.linear import Linear, QuantLinear
from mlx_video_tpu_torch.ops.quant import quantize_dit_params
from mlx_video_tpu_torch.pipelines import generate as tgen

TCFG = tconfig.tiny_test_config(tconfig.LTXModelType.VideoOnly, rope_type=tconfig.LTXRopeType.SPLIT)
JCFG = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)
ATTN = [f"{attn}.{lin}" for attn in ("attn1", "attn2") for lin in ("to_q", "to_k", "to_v", "to_out.0")]


def _dit(seed: int, dtype=torch.float32) -> tm.LTXModel:
    return tm.init_ltx_params(TCFG, torch.Generator().manual_seed(seed), device="cpu", dtype=dtype)


def _jax_dit(model) -> dict:
    """The port's DiT as a JAX tree in its own dtype (bf16 stays bf16)."""
    def leaf(t):
        return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16 if t.dtype == torch.bfloat16 else None)

    return jax.tree.map(leaf, jax_bridge.state_dict_to_jax_layout(model.state_dict()))


def _adapter(path, seed: int, rank: int = 4, prefix: str = "diffusion_model.", layers=(0, 1), extra=()):
    """A reference-format adapter on the attention linears of ``layers``,
    plus ``extra`` (key, in, out) pairs."""
    rng = np.random.default_rng(seed)
    d = TCFG.inner_dim
    state = {}
    for key, n_in, n_out in [(f"transformer_blocks.{i}.{lin}", d, d) for i in layers for lin in ATTN] + list(extra):
        state[f"{prefix}{key}.lora_A.weight"] = rng.normal(size=(rank, n_in)).astype(np.float32) * 0.1
        state[f"{prefix}{key}.lora_B.weight"] = rng.normal(size=(n_out, rank)).astype(np.float32) * 0.1
    save_safetensors(path, state)
    return path


def _counts(out: str):
    return [line.rsplit(" ", 2)[1:] for line in out.splitlines() if line.startswith("[LoRA]")]


def _differing_ulps(got: torch.Tensor, ref: np.ndarray):
    """(count of elements that differ, largest difference in ulps of the dtype)."""
    if got.dtype == torch.bfloat16:
        a = got.view(torch.int16).numpy().astype(np.int64)
        b = np.asarray(jnp.asarray(ref, jnp.bfloat16)).view(np.int16).astype(np.int64)
    else:
        a = got.numpy().view(np.int32).astype(np.int64)
        b = np.asarray(ref, np.float32).view(np.int32).astype(np.int64)
    diff = np.abs(a - b)
    return int((diff > 0).sum()), int(diff.max(initial=0))


# --- the LoRA merge ---

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_lora_matches_jax(tmp_path, capsys, dtype):
    """Two specs in order (strengths 0.5 and 1.0), keys under both
    prefixes, an audio key the video model has no linear for."""
    model = _dit(1, dtype)
    first = _adapter(tmp_path / "a.safetensors", 2, extra=[("audio_attn1.to_q", 32, 32)])
    second = _adapter(tmp_path / "b.safetensors", 3, prefix="model.diffusion_model.", layers=(1,))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    specs = [(first, 0.5), (second, 1.0)]

    ref = jlora.merge_lora_into_params(_jax_dit(model), [jlora.LoraSpec(p, s) for p, s in specs], verbose=True)
    ref_counts = _counts(capsys.readouterr().out)
    merged = tlora.merge_lora_into_params(model, [tlora.LoraSpec(p, s) for p, s in specs], verbose=True)
    assert _counts(capsys.readouterr().out) == ref_counts == [["applied=16", "skipped=1"], ["applied=8", "skipped=0"]]

    ours = jax_bridge.state_dict_to_jax_layout(merged.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        got = ours
        for p in path:
            got = got[p.key]
        n, ulps = _differing_ulps(got, np.asarray(leaf, np.float32))
        if dtype == torch.float32:
            assert ulps <= 1, path
        else:
            assert ulps <= 1 and n <= 1e-4 * got.numel(), path
    for k, v in model.state_dict().items():  # the input is unchanged
        assert torch.equal(v, before[k]), k
    written = {f"blocks.{i}.{lin.replace('.0', '')}.weight" for i in (0, 1) for lin in ATTN}
    base, new = model.state_dict(), merged.state_dict()
    for k in base:  # the unwritten tensors are shared, the written ones new
        assert (base[k].data_ptr() == new[k].data_ptr()) == (k not in written), k


def test_merge_lora_skips_every_pair_of_a_quantized_base(tmp_path, capsys):
    """A 4-bit base: every pair is skipped (runtime adapters are the way for
    it), as the JAX merge counts it, and the words are left as they were."""
    path = _adapter(tmp_path / "a.safetensors", 4)
    jtree = jquant.quantize_dit_params(_jax_dit(_dit(5)), bits=4)
    jlora.merge_lora_into_params(jtree, [jlora.LoraSpec(path, 1.0)])
    ref = _counts(capsys.readouterr().out)
    model = _dit(5)
    quantize_dit_params(model, bits=4)
    merged = tlora.merge_lora_into_params(model, [tlora.LoraSpec(path, 1.0)])
    assert _counts(capsys.readouterr().out) == ref == [["applied=0", "skipped=16"]]
    assert isinstance(merged.blocks[0].attn1.to_q, QuantLinear)
    for k, v in model.state_dict().items():
        assert merged.state_dict()[k].data_ptr() == v.data_ptr(), k


def test_merge_lora_applies_the_strength_only(tmp_path):
    """The reference's convention: alpha / rank never scales the merge (the
    JAX exporter does not bake it into B either): W' = W + strength * B A."""
    path = _adapter(tmp_path / "a.safetensors", 6, rank=8, layers=(0,))
    model = _dit(6)
    merged = tlora.merge_lora_into_params(model, [tlora.LoraSpec(path, 0.25)])
    state = tlora.load_lora_state(path)
    a = state["diffusion_model.transformer_blocks.0.attn1.to_q.lora_A.weight"]
    b = state["diffusion_model.transformer_blocks.0.attn1.to_q.lora_B.weight"]
    want = model.blocks[0].attn1.to_q.weight + (b @ a) * 0.25
    assert torch.equal(merged.blocks[0].attn1.to_q.weight, want)


def test_merge_lora_skips_a_layer_the_model_does_not_have(tmp_path, capsys):
    """A block index past the model's depth names no linear: the port skips
    and counts it. The JAX merge counts it applied and changes nothing (its
    out-of-range ``.at[layer].set`` is dropped): a reference defect, pinned
    here, not copied."""
    path = _adapter(tmp_path / "a.safetensors", 7, layers=(5,))
    tree = _jax_dit(_dit(7))
    ref = jlora.merge_lora_into_params(tree, [jlora.LoraSpec(path, 1.0)], verbose=True)
    assert _counts(capsys.readouterr().out) == [["applied=8", "skipped=0"]]
    for x, y in zip(jax.tree.leaves(ref), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    tlora.merge_lora_into_params(_dit(7), [tlora.LoraSpec(path, 1.0)])
    assert _counts(capsys.readouterr().out) == [["applied=0", "skipped=8"]]


# --- the composed conditioned pipelines against JAX ---

H = W = 128  # the distilled pipeline's multiple of 64: stage 1 at 64 x 64


@pytest.fixture(scope="module")
def parts():
    """Shared narrow components, the port's and JAX's on the same weights."""
    rng = np.random.default_rng(20)
    decoder = tdec.init_video_decoder(torch.Generator().manual_seed(21), tdec.DecoderConfig(**DEC_KW), device="cpu")
    decoder.latents_mean.copy_(torch.from_numpy(rng.normal(size=16).astype(np.float32) * 0.2))
    decoder.latents_std.copy_(torch.from_numpy(rng.uniform(0.8, 1.5, size=16).astype(np.float32)))
    upsampler = tups.init_latent_upsampler(torch.Generator().manual_seed(22), 16, 32, 1, device="cpu")
    encoder = _encoder(23)
    ctx, neg = (torch.from_numpy(rng.normal(size=(1, 8, 48)).astype(np.float32)) for _ in range(2))
    return dict(decoder=decoder, upsampler=upsampler, encoder=encoder, ctx=ctx, neg=neg,
                dec_tree=jax.tree.map(jnp.asarray, jax_bridge.module_to_jax_tree(decoder)),
                ups_tree=jax.tree.map(jnp.asarray, jax_bridge.module_to_jax_tree(upsampler)),
                enc_tree=_jax_tree(encoder))


def _bundles(parts, transformer, stage2=None):
    port = tgen.ModelBundle(transformer, TCFG, parts["decoder"], tdec.DecoderConfig(**DEC_KW), parts["upsampler"],
                            parts["encoder"], tconfig.VideoVAEConfig(**ENC_KW), stage2_transformer=stage2)
    jax_bundle = jgen.ModelBundle(
        _jax_dit(transformer), JCFG, parts["dec_tree"], JaxDecoderConfig(**DEC_KW),
        vae_encoder_params=parts["enc_tree"], vae_encoder_config=JaxVAEConfig(**ENC_KW),
        upsampler_params=parts["ups_tree"], stage2_transformer_params=None if stage2 is None else _jax_dit(stage2),
    )
    return port, jax_bundle


class _JaxDraws:
    """Stands in for ``torch.randn``: returns JAX's draws in order and checks
    each requested shape."""

    def __init__(self, draws):
        self.draws = [np.array(d, np.float32) for d in draws]

    def __call__(self, size, *, generator=None, device=None, dtype=None):
        want = self.draws.pop(0)
        assert tuple(size) == want.shape
        return torch.from_numpy(want).to(device=device, dtype=dtype)


def _write_mp4(path, frames: int, size: int, seed: int):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 24.0, (size, size))
    assert writer.isOpened()
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.uniform(0, 255, (size, size, 3)).astype(np.uint8), (0, 0), 3)
    for i in range(frames):
        writer.write(np.roll(base, 2 * i, axis=1))
    writer.release()
    return path


def _run_both(monkeypatch, tmp_path, port, jax_bundle, parts, seed=3, num_frames=9, **kw):
    """generate_video in both packages on JAX's draws; the per-frame PSNR
    of the latents and of the RGB video."""
    kw = {**dict(height=H, width=W, num_frames=num_frames, stage1_steps=2, stage2_steps=1, seed=seed,
                 tiling="none", video_encoder="cv2"), **kw}
    neg = kw.pop("neg", False)
    jtext = jgen.TextConditioning(jnp.asarray(parts["ctx"].numpy()),
                                  jnp.asarray(parts["neg"].numpy()) if neg else None)
    jkw = {**kw, "pipeline": jgen.PipelineType(kw.get("pipeline", "distilled"))}  # the JAX function takes the enum
    ref = jgen.generate_video(jax_bundle, jtext, dtype=jnp.float32, output_path=tmp_path / "jax.mp4", **jkw)
    keys = jax.random.split(jax.random.key(seed), 8)
    frames = 1 + (num_frames - 1) // 8
    s1 = (1, 16, frames, H // 64, W // 64)
    s2 = (1, 16, frames, H // 32, W // 32)
    decode_cl = jax.random.normal(keys[2], (1, frames, H // 32, W // 32, 16), dtype=jnp.float32)
    draws = _JaxDraws([jax.random.normal(keys[0], s1, dtype=jnp.float32),
                       jax.random.normal(keys[1], s2, dtype=jnp.float32),
                       np.transpose(np.asarray(decode_cl), (0, 4, 1, 2, 3))])
    monkeypatch.setattr(torch, "randn", draws)
    got = tgen.generate_video(port, tgen.TextConditioning(parts["ctx"], parts["neg"] if neg else None),
                              dtype=torch.float32, output_path=tmp_path / "port.mp4", **kw)
    monkeypatch.undo()
    assert draws.draws == []
    assert got.latents.shape == ref.latents.shape == s2 and got.video.shape == ref.video.shape
    assert (tmp_path / "port.mp4").stat().st_size > 0
    peak = float(np.abs(ref.latents).max())
    lat = min(psnr(got.latents[:, :, i], ref.latents[:, :, i], peak) for i in range(frames))
    rgb = min(psnr(got.video[:, :, i], ref.video[:, :, i], 2.0) for i in range(got.video.shape[2]))
    return got, lat, rgb


def test_distilled_image_at_both_stages_matches_jax(monkeypatch, tmp_path, parts):
    """(i) an image at frame 0, replace mode, encoded at 64 x 64 for stage 1
    and 128 x 128 for stage 2; strength 1 keeps latent frame 0 the encoded
    full-size image."""
    port, jax_bundle = _bundles(parts, _dit(30))
    image = str(_write_png(tmp_path / "a.png", H, 30))
    got, lat, rgb = _run_both(monkeypatch, tmp_path, port, jax_bundle, parts, images=[(image, 0, 1.0)])
    assert lat >= 35.0 and rgb >= 35.0
    with torch.no_grad():
        full = tgen._encode_conditionings(port, [(image, 0, 1.0)], H, W, 9, torch.float32)[0].latent
    np.testing.assert_array_equal(got.latents[:, :, :1], full.numpy())
    assert set(got.phase_seconds) == {"cond_encode", "stage1_denoise", "upsample", "stage2_denoise", "vae_decode"}


def test_keyframe_pipeline_matches_jax(monkeypatch, tmp_path, parts):
    """(ii) the keyframe pipeline: two images in guide mode, at media frames
    0 and 8 (latent frames 0 and 1), strengths 1 and 0.7; 3 uniformly
    subsampled stage-1 steps."""
    port, jax_bundle = _bundles(parts, _dit(31))
    images = [(str(_write_png(tmp_path / "a.png", H, 31)), 0, 1.0), (str(_write_png(tmp_path / "b.png", H, 32)), 8, 0.7)]
    _, lat, rgb = _run_both(monkeypatch, tmp_path, port, jax_bundle, parts, pipeline="keyframe", images=images,
                            stage1_steps=3, sigma_subsample="uniform")
    assert lat >= 35.0 and rgb >= 35.0


def test_ic_lora_pipeline_matches_jax(monkeypatch, tmp_path, parts):
    """(iii) the IC-LoRA pipeline: a 9-frame reference video (mp4, cv2) at
    frame 0, strength 0.8, over 17 frames, on a transformer with a merged
    adapter (each package's own merge)."""
    adapter = _adapter(tmp_path / "ic.safetensors", 33)
    base = _dit(33)
    port, jax_bundle = _bundles(parts, tlora.merge_lora_into_params(base, [tlora.LoraSpec(adapter, 1.0)]))
    jax_bundle.transformer_params = jlora.merge_lora_into_params(_jax_dit(base), [jlora.LoraSpec(adapter, 1.0)])
    video = str(_write_mp4(tmp_path / "ref.mp4", 9, H, 33))
    _, lat, rgb = _run_both(monkeypatch, tmp_path, port, jax_bundle, parts, pipeline="ic_lora", num_frames=17,
                            video_conditionings=[(video, 0, 0.8)])
    assert lat >= 35.0 and rgb >= 35.0


@pytest.mark.parametrize("sequential", [False, True])
def test_separate_stage2_model_with_stage2_cfg_matches_jax(monkeypatch, tmp_path, parts, sequential):
    """(iv) a second transformer refines stage 2 with CFG 3.0 on the negative
    embeddings (batched, or two passes), 2 stage-2 steps."""
    port, jax_bundle = _bundles(parts, _dit(34), stage2=_dit(35))
    _, lat, rgb = _run_both(monkeypatch, tmp_path, port, jax_bundle, parts, neg=True, stage2_cfg=True,
                            cfg_scale=3.0, stage2_steps=2, cfg_sequential=sequential)
    assert lat >= 35.0 and rgb >= 35.0


def test_stage2_model_and_cfg_are_used(parts):
    """The stage-2 transformer runs only stage 2, and stage-2 CFG runs only
    with negative embeddings: doubled forwards at stage 2 alone."""
    from mlx_video_tpu_torch.pipelines import denoise as dn

    stage1, stage2 = _dit(36), _dit(37)
    port, _ = _bundles(parts, stage1, stage2=stage2)
    seen, forward = [], dn.ltx_apply

    def spy(model, config, video):
        seen.append(("stage1" if model is stage1 else "stage2", video.latent.shape[0]))
        return forward(model, config, video)

    kw = dict(height=H, width=W, num_frames=9, stage1_steps=2, stage2_steps=1, dtype=torch.float32,
              decode_latents_only=True, stage2_cfg=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dn, "ltx_apply", spy)
        tgen.generate_video(port, tgen.TextConditioning(parts["ctx"], parts["neg"]), **kw)
        assert seen == [("stage1", 1), ("stage1", 1), ("stage2", 2)]
        seen.clear()
        tgen.generate_video(port, tgen.TextConditioning(parts["ctx"]), **kw)
        assert seen == [("stage1", 1), ("stage1", 1), ("stage2", 1)]


# --- batched videos ---

def test_num_videos_matches_single_runs(tmp_path, parts):
    """Two videos at batch 2 against single runs at seed and seed + 1 (and
    against explicit seeds), one mp4 each."""
    port, _ = _bundles(parts, _dit(40))
    text = tgen.TextConditioning(parts["ctx"])
    kw = dict(height=H, width=W, num_frames=9, stage1_steps=2, stage2_steps=1, dtype=torch.float32, tiling="none",
              video_encoder="cv2")
    batched = tgen.generate_video(port, text, seed=5, num_videos=2, output_path=tmp_path / "b.mp4", **kw)
    singles = [tgen.generate_video(port, text, seed=s, **kw) for s in (5, 6)]
    assert batched.latents.shape[0] == 2 and batched.video.shape[0] == 2
    for i, single in enumerate(singles):
        np.testing.assert_allclose(batched.latents[i], single.latents[0], rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(batched.video[i], single.video[0], rtol=2e-4, atol=1e-5)
    assert batched.video_paths == [tmp_path / "b_0.mp4", tmp_path / "b_1.mp4"]
    assert batched.video_path == tmp_path / "b_0.mp4" and all(p.stat().st_size > 0 for p in batched.video_paths)
    by_seeds = tgen.generate_video(port, text, seeds=[6, 5], decode_latents_only=True, **kw)
    np.testing.assert_allclose(by_seeds.latents[0], singles[1].latents[0], rtol=2e-4, atol=1e-5)
    with pytest.raises(ValueError, match="len\\(seeds\\)"):
        tgen.generate_video(port, text, seeds=[1, 2], num_videos=3, **kw)
    with pytest.raises(ValueError, match="num_videos > 1"):
        tgen.generate_video(port, text, num_videos=2, video_conditionings=[("v.mp4", 0, 1.0)], **kw)


# --- streaming decode and the device blend ---

@pytest.mark.parametrize("mode", ["none", "auto", "spatial", "temporal"])
def test_select_tiling_with_stream_matches_jax(mode):
    for h, w, f in [(512, 512, 33), (512, 512, 9), (768, 1024, 121), (256, 256, 65)]:
        got, ref = tgen.select_tiling(mode, h, w, f, stream=True), jgen.select_tiling(mode, h, w, f, stream=True)
        assert (got is None and ref is None) or dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_streamed_frames_equal_the_unstreamed_decode(tmp_path, parts, monkeypatch):
    """stream=True forces temporal tiles at 33 frames (tile 32, overlap 8,
    as phase 11 of chip_smoke.py runs it at full size): the writer receives
    every frame in order, in more than one piece, and
    the pieces equal the returned video's frames bit for bit; decode_latents
    with and without the callback returns the same video."""
    port, _ = _bundles(parts, _dit(41))
    written, write = [], media.VideoWriter.write
    monkeypatch.setattr(media.VideoWriter, "write", lambda self, u8: written.append(u8.copy()) or write(self, u8))
    res = tgen.generate_video(port, tgen.TextConditioning(parts["ctx"]), height=H, width=W, num_frames=33,
                              stage1_steps=1, stage2_steps=1, dtype=torch.float32, tiling="none", stream=True,
                              video_encoder="cv2", output_path=tmp_path / "s.mp4")
    assert len(written) > 1 and sum(len(w) for w in written) == 33
    np.testing.assert_array_equal(np.concatenate(written), media.frames_to_uint8(res.video)[:33])
    cfg = tgen.select_tiling("none", H, W, 33, stream=True)
    latents = torch.from_numpy(res.latents)
    chunks = []
    whole = tgen.decode_latents(port, latents, cfg, decode_timestep=0.05)
    streamed = tgen.decode_latents(port, latents, cfg, decode_timestep=0.05,
                                   on_frames_ready=lambda f, start: chunks.append((start, f)))
    assert len(chunks) > 1 and [start for start, _ in chunks] == list(np.cumsum([0] + [f.shape[2] for _, f in chunks]))[:-1]
    np.testing.assert_array_equal(np.concatenate([f for _, f in chunks], axis=2), whole)
    np.testing.assert_array_equal(streamed, whole)


def test_streamed_decode_matches_the_jax_streamed_decode(parts):
    """The tiles a stream forces (33 frames: temporal, tile 32, overlap 8)
    decode as the JAX package decodes them (>= 35 dB per RGB frame). On
    seeded weights a tiled decode is far from the untiled one, in both
    packages alike (the second tile lacks the first latent frames'
    context): that gap is the reference's, not the port's."""
    cfg = tgen.select_tiling("none", 256, 256, 33, stream=True)
    latents = np.random.default_rng(43).normal(size=(1, 16, 5, 4, 4)).astype(np.float32)
    jax_bundle = jgen.ModelBundle(None, JCFG, parts["dec_tree"], JaxDecoderConfig(**DEC_KW))
    port = tgen.ModelBundle(None, TCFG, parts["decoder"], tdec.DecoderConfig(**DEC_KW))
    with torch.no_grad():
        ours = {c is None: tgen.decode_latents(port, torch.from_numpy(latents), c, decode_timestep=0.05)
                for c in (cfg, None)}
    ref = {c is None: jgen.decode_latents(jax_bundle, jnp.asarray(latents), c, decode_timestep=0.05) for c in (cfg, None)}
    frames = range(33)
    assert min(psnr(ours[False][:, :, i], ref[False][:, :, i], 2.0) for i in frames) >= 35.0
    gap_ours = min(psnr(ours[False][:, :, i], ours[True][:, :, i], 2.0) for i in frames)
    gap_ref = min(psnr(ref[False][:, :, i], ref[True][:, :, i], 2.0) for i in frames)
    assert gap_ref < 35.0 and abs(gap_ours - gap_ref) < 0.5


def test_decode_noise_is_drawn_once_for_the_whole_latents(parts):
    """decode_latents draws the decode noise once, at the latents' shape, and
    mixes it in before tiling: untiled it is the decoder's own draw, bit for
    bit; tiled it is the same noise, sliced."""
    port = tgen.ModelBundle(None, TCFG, parts["decoder"], tdec.DecoderConfig(**DEC_KW))
    cfg = tdec.DecoderConfig(**DEC_KW)
    latents = torch.from_numpy(np.random.default_rng(44).normal(size=(1, 16, 3, 4, 4)).astype(np.float32))
    ts = torch.full((1,), 0.05)
    tiles = ttiling.TilingConfig.spatial_only(tile_size=64, overlap=32)
    with torch.no_grad():
        whole = tgen.decode_latents(port, latents, None, 0.05, generator=torch.Generator().manual_seed(1))
        own = tdec.video_decoder_apply(parts["decoder"], cfg, latents, timestep=ts,
                                       generator=torch.Generator().manual_seed(1)).numpy()
        tiled = tgen.decode_latents(port, latents, tiles, 0.05, generator=torch.Generator().manual_seed(1))
        mixed = tdec.add_decode_noise(cfg, latents, generator=torch.Generator().manual_seed(1))
        premixed = tgen.decode_latents(port, mixed, tiles, 0.05)
    np.testing.assert_array_equal(whole, own)
    np.testing.assert_array_equal(tiled, premixed)
    assert not np.array_equal(tiled, tgen.decode_latents(port, latents, tiles, 0.05))


@pytest.mark.parametrize("config", [
    ttiling.TilingConfig.spatial_only(tile_size=64, overlap=32),
    ttiling.TilingConfig.temporal_only(tile_size=16, overlap=8),
    ttiling.TilingConfig(ttiling.SpatialTilingConfig(64, 32), ttiling.TemporalTilingConfig(16, 8)),
])
def test_device_blend_equals_the_host_blend(parts, config):
    """decode_with_tiling_device against decode_with_tiling on the same tiles
    (here both on the CPU): the return value and every emitted range."""
    rng = np.random.default_rng(42)
    latents = torch.from_numpy(rng.normal(size=(1, 16, 3, 4, 4)).astype(np.float32))
    dec = parts["decoder"]

    def decode(tile: torch.Tensor) -> torch.Tensor:
        return tdec.video_decoder_apply(dec, tdec.DecoderConfig(**DEC_KW), tile.contiguous())

    host_chunks, dev_chunks = [], []
    with torch.no_grad():
        host = ttiling.decode_with_tiling(lambda t: decode(torch.from_numpy(t)).numpy(), latents.numpy(), config,
                                          on_frames_ready=lambda f, s: host_chunks.append((s, f)))
        dev = ttiling.decode_with_tiling_device(decode, latents, config,
                                                on_frames_ready=lambda f, s: dev_chunks.append((s, f)))
    assert dev.shape == host.shape == (1, 3, 17, 128, 128) and dev.dtype == np.float32
    np.testing.assert_allclose(dev, host, atol=1e-6, rtol=0)
    assert [s for s, _ in dev_chunks] == [s for s, _ in host_chunks]
    for (_, a), (_, b) in zip(dev_chunks, host_chunks):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


# --- the loader ---

@pytest.mark.parametrize("pipeline", ["keyframe", "ic_lora"])
def test_load_model_bundle_takes_the_conditioning_pipelines_and_a_stage2_file(tmp_path, monkeypatch, pipeline):
    """The keyframe and IC-LoRA pipelines read the distilled file, and
    ``stage2_path`` a second distilled file from its own directory. The DiT
    read is a spy (the loader builds the 19B geometry)."""
    files = []
    for root in (tmp_path / "main", tmp_path / "stage2"):
        (root / "vae").mkdir(parents=True)
        save_safetensors(root / "ltx-2-19b-distilled.safetensors", {"x": np.zeros(1, np.float32)})
    save_safetensors(tmp_path / "main" / "vae" / "diffusion_pytorch_model.safetensors", {"x": np.zeros(1, np.float32)})
    monkeypatch.setattr(tloading, "load_dit_params", lambda paths, *a, **kw: files.append(paths[0]) or len(files))
    monkeypatch.setattr(tloading, "DecoderConfig", lambda: tdec.DecoderConfig(**DEC_KW))
    monkeypatch.setattr(tloading.vae_weights, "load_video_decoder_weights", lambda *a: None)
    bundle = tloading.load_model_bundle(tmp_path / "main", pipeline=pipeline, stage2_path=tmp_path / "stage2",
                                        dtype=torch.float32, device="cpu")
    assert files == [tmp_path / "main" / "ltx-2-19b-distilled.safetensors",
                     tmp_path / "stage2" / "ltx-2-19b-distilled.safetensors"]
    assert (bundle.transformer, bundle.stage2_transformer) == (1, 2)
    assert tloading.load_model_bundle(tmp_path / "main", pipeline=pipeline, dtype=torch.float32,
                                      device="cpu").stage2_transformer is None


def test_quantize_models_reaches_the_stage2_transformer():
    """As the JAX function: W4A8 (and W8A8) convert both transformers,
    --quantize-bits only the stage-1 one."""
    models = tgen.ModelBundle(_dit(50), TCFG, None, None, stage2_transformer=_dit(51))
    tloading.quantize_models(models, quantize_bits=4)
    assert isinstance(models.transformer.blocks[0].attn1.to_q, QuantLinear)
    assert isinstance(models.stage2_transformer.blocks[0].attn1.to_q, Linear)
    tloading.quantize_models(models, w4a8=True)
    for model in (models.transformer, models.stage2_transformer):
        assert model.blocks[0].attn1.to_q.int8_scale is not None
        assert isinstance(model.blocks[1].ff.proj_out, QuantLinear) and model.blocks[1].ff.proj_out.bits == 4
