"""The port's dev pipeline against the JAX package, on the CPU: the VAE
encoder, its weights, the conditioning state, the CFG denoise loop and the
composed image -> encode -> state -> CFG denoise -> decode pipeline.

Weights cross between the frameworks through io/jax_bridge.py; inputs and
noise come from seeded numpy generators (or JAX's draws, handed to the
port), images are PNGs written with cv2 and read by both packages' loaders.
Bars, each with its reason:
- the encoder, fp32: 5e-4 relative to the output's largest value, the VAE
  decoder's bar (convolutions summed in another order);
- weights (bridge and checkpoint loaders) and the conditioning state: exact,
  the same values moved or the same fp32 operations;
- the CFG denoise loop, fp32, 2 steps at CFG 4.5: 5e-4 relative to the
  largest latent (the DiT's bar; CFG multiplies the velocity difference by
  4.5 and the loop keeps it within the bar);
- the composed pipeline: per-frame latent and RGB PSNR >= 35 dB, the gate of
  tests/test_torch_port_pipeline.py.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_video_tpu.config import LTXModelType, LTXRopeType, VideoVAEConfig as JaxVAEConfig, tiny_test_config
from mlx_video_tpu.io import media as jmedia
from mlx_video_tpu.io import vae_weights as jvae
from mlx_video_tpu.io.safetensors import save_safetensors
from mlx_video_tpu.models.ltx.video_vae import encoder as jenc
from mlx_video_tpu.models.ltx.video_vae.decoder import DecoderConfig as JaxDecoderConfig
from mlx_video_tpu.pipelines import conditioning as jcond
from mlx_video_tpu.pipelines import denoise as jdn
from mlx_video_tpu.pipelines import generate as jgen
from mlx_video_tpu.pipelines.positions import create_position_grid
from mlx_video_tpu.pipelines.schedulers import ltx2_scheduler
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch import loading as tloading
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.io import vae_weights as tvae
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.models.ltx.video_vae import decoder as tdec
from mlx_video_tpu_torch.models.ltx.video_vae import encoder as tenc
from mlx_video_tpu_torch.pipelines import conditioning as tcond
from mlx_video_tpu_torch.pipelines import denoise as tdn
from mlx_video_tpu_torch.pipelines import generate as tgen

# A narrow encoder with every kind of block: 16 latent channels (the tiny
# DiT's), space /32 and time /8 as the default.
ENC_BLOCKS = (
    ("res_x", {"num_layers": 1}), ("compress_space_res", {"multiplier": 2}), ("compress_time_res", {"multiplier": 1}),
    ("compress_all", {"multiplier": 1}), ("compress_all_res", {"multiplier": 1}), ("res_x_y", {"multiplier": 1}),
)
ENC_KW = dict(out_channels=16, latent_channels=16, encoder_blocks=ENC_BLOCKS)
DEC_KW = dict(in_channels=16, base_channels=32, num_layers_per_block=1, num_upsamples=3, patch_size=4)


def psnr(a, b, peak: float) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _encoder(seed: int = 0) -> tenc.VideoEncoder:
    g = torch.Generator().manual_seed(seed)
    enc = tenc.init_video_encoder(g, tconfig.VideoVAEConfig(**ENC_KW), device="cpu")
    enc.per_channel_statistics.mean.normal_(generator=g).mul_(0.2)
    enc.per_channel_statistics.std.uniform_(0.8, 1.5, generator=g)
    return enc


def _jax_tree(module) -> dict:
    return jax.tree.map(jnp.asarray, jax_bridge.encoder_to_jax_tree(module))


def _write_png(path, size, seed):
    noise = np.random.default_rng(seed).uniform(0, 255, (size, size, 3)).astype(np.uint8)
    assert cv2.imwrite(str(path), cv2.GaussianBlur(noise, (0, 0), 2))
    return path


# --- VAE encoder ---

@pytest.mark.parametrize("frames", [1, 9])
def test_encoder_matches_jax(frames):
    enc = _encoder()
    video = np.random.default_rng(frames).uniform(-1, 1, size=(1, 3, frames, 64, 64)).astype(np.float32)
    ref = np.asarray(jenc.video_encoder_apply(_jax_tree(enc), JaxVAEConfig(**ENC_KW), jnp.asarray(video)))
    with torch.no_grad():
        got = tenc.video_encoder_apply(enc, tconfig.VideoVAEConfig(**ENC_KW), torch.from_numpy(video)).numpy()
    assert got.shape == ref.shape == (1, 16, 1 + (frames - 1) // 8, 2, 2)
    assert np.abs(got - ref).max() <= 5e-4 * np.abs(ref).max()


def test_encode_image_matches_jax():
    enc = _encoder(1)
    image = np.random.default_rng(2).uniform(0, 1, size=(64, 96, 3)).astype(np.float32)
    ref = np.asarray(jenc.encode_image(_jax_tree(enc), JaxVAEConfig(**ENC_KW), jnp.asarray(image)))
    with torch.no_grad():
        got = tenc.encode_image(enc, tconfig.VideoVAEConfig(**ENC_KW), torch.from_numpy(image)).numpy()
    assert got.shape == ref.shape == (1, 16, 1, 2, 3)
    assert np.abs(got - ref).max() <= 5e-4 * np.abs(ref).max()


def test_encoder_rejects_bad_frame_counts():
    with pytest.raises(ValueError, match="1 \\+ 8"):
        tenc.video_encoder_apply(_encoder(), tconfig.VideoVAEConfig(**ENC_KW), torch.zeros(1, 3, 4, 64, 64))


def _assert_same_tree(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_tree(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y), k


def test_encoder_bridge_round_trip_is_bit_exact():
    tree = jax.tree.map(np.asarray, jenc.init_video_encoder(jax.random.key(3), JaxVAEConfig(**ENC_KW)))
    tree["per_channel_statistics"]["mean"] = np.random.default_rng(3).normal(size=16).astype(np.float32)
    enc = tenc.VideoEncoder(tconfig.VideoVAEConfig(**ENC_KW), device="cpu", dtype=torch.float32)
    jax_bridge.load_jax_params(enc, tree)
    _assert_same_tree(tree, jax_bridge.encoder_to_jax_tree(enc))


def _checkpoint_key(name: str) -> str:
    """Port encoder name -> checkpoint key, with the CausalConv ``.conv``
    nesting of real checkpoints."""
    if name.startswith("per_channel_statistics."):
        return "vae.per_channel_statistics." + {"mean": "mean-of-means", "std": "std-of-means"}[name.split(".")[-1]]
    parts = name.split(".")
    return "vae.encoder." + ".".join(parts[:-1] + ["conv", parts[-1]])


def test_encoder_loader_matches_jax(tmp_path):
    source = _encoder(4)
    path = tmp_path / "vae.safetensors"
    save_safetensors(path, {_checkpoint_key(k): v.numpy() for k, v in source.state_dict().items()})
    params = jenc.init_video_encoder(jax.random.key(0), JaxVAEConfig(**ENC_KW), dtype=jnp.float32)
    n_ref = jvae.load_video_encoder_weights(path, params, dtype=jnp.float32)
    ours = tenc.VideoEncoder(tconfig.VideoVAEConfig(**ENC_KW), device="cpu", dtype=torch.float32)
    assert tvae.load_video_encoder_weights(path, ours) == n_ref == len(ours.state_dict())
    _assert_same_tree(jax.tree.map(np.asarray, params), jax_bridge.encoder_to_jax_tree(ours))
    for k, v in source.state_dict().items():
        assert torch.equal(ours.state_dict()[k], v), k


def test_load_model_bundle_picks_the_dev_file_and_the_encoder(tmp_path, monkeypatch):
    """The loader builds the 19B geometry; here its configs are the tiny
    ones and the DiT read is a spy, to see which file it picks and that the
    encoder comes from the VAE file."""
    enc, files = _encoder(5), []
    (tmp_path / "vae").mkdir()
    save_safetensors(tmp_path / "vae" / "diffusion_pytorch_model.safetensors",
                     {_checkpoint_key(k): v.numpy() for k, v in enc.state_dict().items()})
    for kind in ("dev", "distilled"):
        save_safetensors(tmp_path / f"ltx-2-19b-{kind}.safetensors", {"x": np.zeros(1, np.float32)})
    monkeypatch.setattr(tloading, "load_dit_params", lambda paths, *a, **kw: files.append(paths[0].name))
    monkeypatch.setattr(tloading, "DecoderConfig", lambda: tdec.DecoderConfig(**DEC_KW))
    monkeypatch.setattr(tloading, "VideoVAEConfig", lambda: tconfig.VideoVAEConfig(**ENC_KW))
    bundle = tloading.load_model_bundle(tmp_path, pipeline="dev", load_encoder=True, dtype=torch.float32, device="cpu")
    assert files == ["ltx-2-19b-dev.safetensors"] and bundle.upsampler is None
    for k, v in enc.state_dict().items():
        assert torch.equal(bundle.vae_encoder.state_dict()[k], v), k
    tloading.load_model_bundle(tmp_path, dtype=torch.float32, device="cpu")
    assert files[-1] == "ltx-2-19b-distilled.safetensors"


# --- conditioning state ---

def test_conditioning_matches_jax_on_shared_noise():
    rng = np.random.default_rng(7)
    shape = (1, 16, 4, 3, 5)
    latent = rng.normal(size=shape).astype(np.float32)
    c_img, c_key, c_long = (rng.normal(size=(1, 16, n, 3, 5)).astype(np.float32) for n in (1, 2, 3))
    jconds = [jcond.VideoConditionByLatentIndex(jnp.asarray(c_img), 0, 1.0),
              jcond.VideoConditionByKeyframeIndex(jnp.asarray(c_key), 1, 0.5),
              jcond.VideoConditionByLatentIndex(jnp.asarray(c_long), 3, 0.7)]
    tconds = [tcond.VideoConditionByLatentIndex(torch.from_numpy(c_img), 0, 1.0),
              tcond.VideoConditionByKeyframeIndex(torch.from_numpy(c_key), 1, 0.5),
              tcond.VideoConditionByLatentIndex(torch.from_numpy(c_long), 3, 0.7)]
    jstate = jcond.apply_conditioning(jcond.create_initial_state(shape)._replace(latent=jnp.asarray(latent)), jconds)
    tstate = tcond.apply_conditioning(tcond.create_initial_state(shape, noise=torch.from_numpy(latent)), tconds)
    for a, b in zip(tstate, jstate):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    key = jax.random.key(8)
    noise = np.array(jax.random.normal(key, shape, dtype=jnp.float32))
    jnoisy = jcond.add_noise_with_state(jstate, key, 0.9)
    tnoisy = tcond.add_noise_with_state(tstate, 0.9, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(tnoisy.latent.numpy(), np.asarray(jnoisy.latent), atol=1e-6, rtol=0)
    den = rng.normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(
        tcond.apply_denoise_mask(torch.from_numpy(den), tstate.clean_latent, tstate.denoise_mask).numpy(),
        np.asarray(jcond.apply_denoise_mask(jnp.asarray(den), jstate.clean_latent, jstate.denoise_mask)),
        atol=1e-6, rtol=0,
    )
    for ours, theirs in ((tstate, jstate), (None, None)):
        np.testing.assert_array_equal(tdn.video_timesteps_mask(ours, shape, torch.float32).numpy(),
                                      np.asarray(jdn.video_timesteps_mask(theirs, shape, jnp.float32)))


def test_conditioning_rejects_bad_placements():
    state = tcond.create_initial_state((1, 16, 2, 3, 5), generator=torch.Generator().manual_seed(0))
    assert state.latent.std() > 0 and state.denoise_mask.shape == (1, 1, 2, 1, 1)
    with pytest.raises(ValueError, match="does not match"):
        tcond.apply_conditioning(state, [tcond.VideoConditionByLatentIndex(torch.zeros(1, 16, 1, 3, 4))])
    with pytest.raises(ValueError, match="out of bounds"):
        tcond.apply_conditioning(state, [tcond.VideoConditionByLatentIndex(torch.zeros(1, 16, 1, 3, 5), 2)])


@pytest.mark.parametrize("args", [(0, 9, 2), (1, 9, 2), (5, 33, 5), (32, 33, 5), (8, 65, 9), (3, 1, 1), (40, 65, 9)])
def test_resolve_frame_idx_matches_jax(args):
    assert tgen._resolve_frame_idx(*args) == jgen._resolve_frame_idx(*args)


# --- CFG denoise ---

@pytest.fixture(scope="module")
def tiny_dit():
    cfg = tconfig.tiny_test_config(tconfig.LTXModelType.VideoOnly, rope_type=tconfig.LTXRopeType.SPLIT)
    model = tm.init_ltx_params(cfg, torch.Generator().manual_seed(9), device="cpu", dtype=torch.float32)
    params = jax.tree.map(jnp.asarray, jax_bridge.module_to_jax_tree(model))
    return model, cfg, params, tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)


@pytest.mark.parametrize("sequential", [False, True])
def test_cfg_denoise_with_state_matches_jax(tiny_dit, sequential):
    model, cfg, params, jcfg = tiny_dit
    rng = np.random.default_rng(10)
    shape = (1, 16, 3, 4, 4)
    latent, cond = rng.normal(size=shape).astype(np.float32), rng.normal(size=(1, 16, 1, 4, 4)).astype(np.float32)
    ctx, neg = (rng.normal(size=(1, 8, 48)).astype(np.float32) for _ in range(2))
    pos = create_position_grid(1, 3, 4, 4)
    sigmas = ltx2_scheduler(2, num_tokens=48)
    jstate = jcond.apply_conditioning(jcond.create_initial_state(shape)._replace(latent=jnp.asarray(latent)),
                                      [jcond.VideoConditionByLatentIndex(jnp.asarray(cond), 0, 0.8)])
    ref, _ = jdn.denoise(params, jcfg, None, jnp.asarray(pos), jnp.asarray(ctx), sigmas, neg_context=jnp.asarray(neg),
                         cfg_scale=4.5, state=jstate, cfg_sequential=sequential)
    tstate = tcond.LatentState(*(torch.from_numpy(np.array(x)) for x in jstate))
    got, _ = tdn.denoise(model, cfg, None, torch.from_numpy(pos), torch.from_numpy(ctx), sigmas,
                      neg_context=torch.from_numpy(neg), cfg_scale=4.5, state=tstate, cfg_sequential=sequential)
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= 5e-4 * np.abs(ref).max()


def test_denoise_without_negative_context_has_no_cfg(tiny_dit):
    """As the JAX package: no neg_context means no CFG, whatever cfg_scale."""
    model, cfg, _, _ = tiny_dit
    rng = np.random.default_rng(11)
    lat = torch.from_numpy(rng.normal(size=(1, 16, 2, 4, 4)).astype(np.float32))
    pos, ctx = torch.from_numpy(create_position_grid(1, 2, 4, 4)), torch.from_numpy(rng.normal(size=(1, 8, 48))).float()
    sigmas = ltx2_scheduler(2, num_tokens=32)
    a, _ = tdn.denoise(model, cfg, lat, pos, ctx, sigmas, cfg_scale=4.5)
    assert torch.equal(a, tdn.denoise(model, cfg, lat, pos, ctx, sigmas, cfg_scale=1.0)[0])
    guided, _ = tdn.denoise(model, cfg, lat, pos, ctx, sigmas, neg_context=ctx.flip(1), cfg_scale=4.5)
    assert not torch.equal(a, guided)


# --- the composed dev pipeline ---

def test_composed_dev_pipeline_psnr_gate(tiny_dit, tmp_path):
    """image -> encode -> conditioning state -> batched CFG denoise (2 steps)
    -> decode, in both frameworks on shared weights, image and noise."""
    model, cfg, params, jcfg = tiny_dit
    enc = _encoder(12)
    enc_params = _jax_tree(enc)
    decoder = tdec.init_video_decoder(torch.Generator().manual_seed(13), tdec.DecoderConfig(**DEC_KW), device="cpu")
    dec_params = jax.tree.map(jnp.asarray, jax_bridge.module_to_jax_tree(decoder))
    image = _write_png(tmp_path / "cond.png", 64, 14)
    rng = np.random.default_rng(14)
    ctx, neg = (rng.normal(size=(1, 8, 48)).astype(np.float32) for _ in range(2))
    shape, pos = (1, 16, 2, 2, 2), create_position_grid(1, 2, 2, 2)
    sigmas = ltx2_scheduler(2, num_tokens=8)
    key = jax.random.key(15)
    tiling = None

    # JAX
    pixels = jmedia.prepare_image_for_encoding(jmedia.load_image(image, 64, 64), 64, 64)
    jlatent = jenc.video_encoder_apply(enc_params, JaxVAEConfig(**ENC_KW), jnp.asarray(pixels))
    conds = [jcond.VideoConditionByLatentIndex(jlatent, 0, 1.0)]
    jlat, jstate = jgen._init_state_with_conditioning(shape, conds, key, float(sigmas[0]), jnp.float32)
    jout, _ = jdn.denoise(params, jcfg, jlat, jnp.asarray(pos), jnp.asarray(ctx), sigmas, neg_context=jnp.asarray(neg),
                          cfg_scale=4.5, state=jstate)
    jrgb = jgen.decode_latents(jgen.ModelBundle(None, jcfg, dec_params, JaxDecoderConfig(**DEC_KW)), jout, tiling,
                               decode_timestep=0.05)

    # the port, on the same weights, image and noise
    bundle = tgen.ModelBundle(model, cfg, decoder, tdec.DecoderConfig(**DEC_KW), vae_encoder=enc,
                              vae_encoder_config=tconfig.VideoVAEConfig(**ENC_KW))
    with torch.no_grad():
        tconds = tgen._encode_conditionings(bundle, [(str(image), 0, 1.0)], 64, 64, 9, torch.float32)
    np.testing.assert_allclose(tconds[0].latent.numpy(), np.asarray(jlatent), atol=5e-4 * float(jnp.abs(jlatent).max()))
    zeros = torch.zeros(shape)
    state = tcond.apply_conditioning(tcond.LatentState(zeros, zeros, torch.ones(1, 1, 2, 1, 1)), tconds)
    noise = torch.from_numpy(np.array(jax.random.normal(key, shape, dtype=jnp.float32)))
    state = tcond.add_noise_with_state(state, float(sigmas[0]), noise=noise)
    out, _ = tdn.denoise(model, cfg, state.latent, torch.from_numpy(pos), torch.from_numpy(ctx), sigmas,
                      neg_context=torch.from_numpy(neg), cfg_scale=4.5, state=state)
    rgb = tgen.decode_latents(bundle, out, tiling, decode_timestep=0.05)

    jout = np.asarray(jout)
    peak = float(np.abs(jout).max())
    assert rgb.shape == jrgb.shape == (1, 3, 9, 64, 64)
    assert min(psnr(out.numpy()[:, :, i], jout[:, :, i], peak) for i in range(2)) >= 35.0
    assert min(psnr(rgb[:, :, i], jrgb[:, :, i], 2.0) for i in range(9)) >= 35.0


@pytest.fixture(scope="module")
def dev_bundle(tiny_dit):
    model, cfg, _, _ = tiny_dit
    decoder = tdec.init_video_decoder(torch.Generator().manual_seed(16), tdec.DecoderConfig(**DEC_KW), device="cpu")
    return tgen.ModelBundle(model, cfg, decoder, tdec.DecoderConfig(**DEC_KW), vae_encoder=_encoder(17),
                            vae_encoder_config=tconfig.VideoVAEConfig(**ENC_KW))


def _dev(bundle, text, image, seed=3, strength=1.0, **kw):
    args = dict(height=64, width=64, num_frames=9, pipeline="dev", num_inference_steps=2, cfg_scale=4.5,
                dtype=torch.float32, tiling="none", images=[(str(image), 0, strength)])
    return tgen.generate_video(bundle, text, generator=torch.Generator().manual_seed(seed), **{**args, **kw})


def test_generate_video_dev_with_an_image(dev_bundle, tmp_path):
    image = _write_png(tmp_path / "img.png", 64, 18)
    rng = np.random.default_rng(18)
    text = tgen.TextConditioning(*(torch.from_numpy(rng.normal(size=(1, 8, 48)).astype(np.float32)) for _ in range(2)))
    a, b, c = _dev(dev_bundle, text, image), _dev(dev_bundle, text, image), _dev(dev_bundle, text, image, seed=4)
    assert a.video.shape == (1, 3, 9, 64, 64) and a.latents.shape == (1, 16, 2, 2, 2) and np.isfinite(a.video).all()
    assert set(a.phase_seconds) == {"cond_encode", "dev_denoise", "vae_decode"}
    np.testing.assert_array_equal(a.video, b.video)
    assert not np.array_equal(a.latents[:, :, 1:], c.latents[:, :, 1:])
    with torch.no_grad():
        encoded = tgen._encode_conditionings(dev_bundle, [(str(image), 0, 1.0)], 64, 64, 9, torch.float32)[0].latent
    np.testing.assert_array_equal(a.latents[:, :, :1], encoded.numpy())  # strength 1.0 keeps frame 0 clean
    half = _dev(dev_bundle, text, image, strength=0.5)
    assert not np.array_equal(half.latents[:, :, :1], encoded.numpy())
    seq = _dev(dev_bundle, text, image, cfg_sequential=True)
    np.testing.assert_allclose(seq.latents, a.latents, atol=1e-5 * np.abs(a.latents).max())
    no_neg = tgen.TextConditioning(text.video_embeddings)  # no CFG without a negative prompt, as in JAX
    np.testing.assert_array_equal(_dev(dev_bundle, no_neg, image).latents,
                                  _dev(dev_bundle, no_neg, image, cfg_scale=1.0).latents)


def test_generate_video_refuses_what_is_not_ported(dev_bundle, tmp_path):
    """What generate_video refuses, as the JAX function does: the IC-LoRA
    pipeline without a video, video conditionings in the dev pipeline, an
    unknown sigma subsampling, conditionings in a batch of videos, and
    conditioning without a VAE encoder."""
    text = tgen.TextConditioning(torch.zeros(1, 8, 48))
    with pytest.raises(ValueError, match="IC-LoRA pipeline requires video conditionings"):
        tgen.generate_video(dev_bundle, text, pipeline="ic_lora", dtype=torch.float32)
    with pytest.raises(ValueError, match="Video conditioning is only supported"):
        tgen.generate_video(dev_bundle, text, pipeline="dev", video_conditionings=[("v.mp4", 0, 1.0)],
                            dtype=torch.float32)
    with pytest.raises(ValueError, match="sigma_subsample"):
        tgen.generate_video(dev_bundle, text, sigma_subsample="linear", dtype=torch.float32)
    with pytest.raises(ValueError, match="num_videos > 1"):
        tgen.generate_video(dev_bundle, text, num_videos=2, images=[("a.png", 0, 1.0)], dtype=torch.float32)
    no_encoder = tgen.ModelBundle(dev_bundle.transformer, dev_bundle.transformer_config, dev_bundle.vae_decoder,
                                  dev_bundle.vae_decoder_config)
    with pytest.raises(ValueError, match="VAE encoder"):
        tgen.generate_video(no_encoder, text, height=64, width=64, num_frames=9, pipeline="dev",
                            images=[(str(_write_png(tmp_path / "x.png", 64, 0)), 0, 1.0)], dtype=torch.float32)
