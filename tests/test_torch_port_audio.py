"""The port's audio generation against the JAX package, on the CPU, at narrow
width (a 2-layer AudioVideo DiT with 128-wide audio tokens, a narrow audio
VAE decoder and vocoder, fp32), on shared weights (io/jax_bridge.py):

- ``ltx_apply`` of an AudioVideo model (per-token video timesteps with
  conditioned frames at sigma 0, the shared (B, 1) audio timestep), of the
  same model on video alone and of an AudioOnly model on its audio weights;
- the joint ``denoise`` (distilled; batched and sequential CFG) and
  ``denoise_audio_only``;
- ``audio_decoder_apply``, ``vocoder_apply`` and ``decode_audio``;
- ``generate_video`` whole on JAX's draws (``jax.random.normal`` of keys 0,
  1, 5, 6, 7 and 2 of the split seed, handed to the port by standing in for
  ``torch.randn``): joint distilled, separate distilled with an image, joint
  dev with CFG;
- the loaders (audio VAE decoder, vocoder, AudioVideo and AudioOnly DiTs),
  ``quantize_models`` and ``merge_lora_into_params`` on the AudioVideo model.

Bars, each with its reason:
- forwards: 5e-4 relative to the output's largest value, the DiT bar of
  tests/test_torch_port_dit.py;
- denoise loops and composed pipelines: per-frame latent PSNR >= 35 dB (and
  over the whole audio latent, peak its largest absolute value), the repo's
  pipeline gate (tests/test_torch_port_pipeline.py); the waveform the same;
- audio decoder, vocoder and decode_audio: rtol 1e-4 (fp32 convolutions
  reduce in another order), with atol 1e-5 for values near zero;
- loaders: exact (the same bits); quantization: the same linears, by name;
  LoRA merges: 1e-6 absolute (fp32 products summed in another order).
"""

import dataclasses
import re
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_dev import DEC_KW, ENC_KW, _encoder, _write_png, psnr

from mlx_video_tpu import lora as jlora
from mlx_video_tpu.config import LTXModelType, LTXRopeType, VideoVAEConfig as JaxVAEConfig, tiny_test_config
from mlx_video_tpu.io import vae_weights as jvae
from mlx_video_tpu.io import weights as jweights
from mlx_video_tpu.io.safetensors import save_safetensors
from mlx_video_tpu.models.ltx import model as jm
from mlx_video_tpu.models.ltx.audio_vae import audio_vae as jaudio
from mlx_video_tpu.models.ltx.audio_vae import vocoder as jvoc
from mlx_video_tpu.models.ltx.video_vae.decoder import DecoderConfig as JaxDecoderConfig
from mlx_video_tpu.ops import int8 as jint8
from mlx_video_tpu.ops import quant as jquant
from mlx_video_tpu.pipelines import denoise as jdn
from mlx_video_tpu.pipelines import generate as jgen
from mlx_video_tpu.pipelines.positions import create_audio_position_grid, create_position_grid
from mlx_video_tpu.pipelines.schedulers import STAGE_1_SIGMAS, subsample_sigmas
from mlx_video_tpu.convert import build_unified_bundle
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch import loading as tloading
from mlx_video_tpu_torch import lora as tlora
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.io import vae_weights as tvae
from mlx_video_tpu_torch.io import weights as tweights
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.models.ltx import upsampler as tups
from mlx_video_tpu_torch.models.ltx.audio_vae import audio_vae as taudio
from mlx_video_tpu_torch.models.ltx.audio_vae import vocoder as tvoc
from mlx_video_tpu_torch.models.ltx.video_vae import decoder as tdec
from mlx_video_tpu_torch.ops.linear import Int8Linear, QuantLinear
from mlx_video_tpu_torch.pipelines import denoise as tdn
from mlx_video_tpu_torch.pipelines import generate as tgen

# Audio tokens are C * M = 8 * 16 = 128 wide at the pipeline's latent geometry
CFG = dataclasses.replace(tiny_test_config(LTXModelType.AudioVideo, rope_type=LTXRopeType.SPLIT),
                          audio_in_channels=128, audio_out_channels=128)
AO_CFG = dataclasses.replace(CFG, model_type=LTXModelType.AudioOnly)
TCFG = tconfig.LTXModelConfig.from_dict(CFG.to_dict())
TAO_CFG = tconfig.LTXModelConfig.from_dict(AO_CFG.to_dict())
AUDIO_BLOCK = ("audio_attn1", "audio_attn2", "audio_ff", "audio_scale_shift_table")
# a narrow audio VAE decoder and vocoder (the default geometry at a quarter
# and a sixteenth of the channels)
AVAE = dict(ch=32)
VOC = dict(upsample_initial_channel=64)
FWD_BAR = 5e-4


def _randomize_(module, seed=0):
    """Non-zero biases, norms and tables, so a wrong index cannot hide
    behind zeros or ones."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(("bias", "scale_shift_table", "scale_shift_table_a2v_ca_audio",
                              "scale_shift_table_a2v_ca_video")) or "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return module


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _audio_only_tree(av_tree: dict) -> dict:
    """The audio part of an AudioVideo JAX tree: an AudioOnly model's tree."""
    return {"audio": av_tree["audio"], "blocks": {k: av_tree["blocks"][k] for k in AUDIO_BLOCK}}


@pytest.fixture(scope="module")
def av():
    model = _randomize_(tm.init_ltx_params(TCFG, torch.Generator().manual_seed(0), device="cpu",
                                           dtype=torch.float32))
    tree = jax_bridge.module_to_jax_tree(model)
    audio_only = jax_bridge.load_jax_params(tm.LTXModel(TAO_CFG, device="cpu", dtype=torch.float32),
                                            _audio_only_tree(tree))
    return model, _jax(tree), audio_only


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())


def _inputs(seed: int, b: int = 1, f: int = 2, h: int = 4, w: int = 4, t: int = 6, conditioned: bool = False):
    """Numpy inputs of both modalities; with ``conditioned`` the video's
    per-token timesteps are 0 on its first latent frame (a conditioned
    frame) and sigma elsewhere."""
    rng = np.random.default_rng(seed)
    s = f * h * w
    v_ts = np.full((b, 1), 0.6, np.float32)
    if conditioned:
        v_ts = np.where(np.arange(s)[None] < h * w, 0.0, 0.6).astype(np.float32).repeat(b, 0)
    return dict(
        video=dict(latent=rng.normal(size=(b, s, CFG.in_channels)).astype(np.float32), timesteps=v_ts,
                   context=rng.normal(size=(b, 5, CFG.caption_channels)).astype(np.float32),
                   positions=create_position_grid(b, f, h, w)),
        audio=dict(latent=rng.normal(size=(b, t, CFG.audio_in_channels)).astype(np.float32),
                   timesteps=np.full((b, 1), 0.6, np.float32),
                   context=rng.normal(size=(b, 7, CFG.audio_caption_channels)).astype(np.float32),
                   positions=create_audio_position_grid(b, t)),
    )


def _mods(inputs, which):
    """(JAX, port) Modality pairs for the modalities in ``which``."""
    out = {}
    for name in ("video", "audio"):
        d = inputs[name]
        out[name] = (jm.Modality(**{k: jnp.asarray(v) for k, v in d.items()}),
                     tm.Modality(**{k: torch.from_numpy(v) for k, v in d.items()})) if name in which else (None, None)
    return out


@pytest.mark.parametrize("case", ["av", "av_conditioned", "av_batch2", "av_video_only", "audio_only"])
def test_ltx_apply_matches(av, case):
    model, params, audio_only = av
    inputs = _inputs(3, b=2 if case == "av_batch2" else 1, conditioned=case == "av_conditioned")
    which = {"av_video_only": ("video",), "audio_only": ("audio",)}.get(case, ("video", "audio"))
    mods = _mods(inputs, which)
    if case == "audio_only":
        rv, ra = jm.ltx_apply(_jax(_audio_only_tree(jax.tree.map(np.asarray, params))), AO_CFG,
                              audio=mods["audio"][0])
        gv, ga = tm.ltx_apply(audio_only, TAO_CFG, None, mods["audio"][1])
    else:
        rv, ra = jm.ltx_apply(params, CFG, video=mods["video"][0], audio=mods["audio"][0])
        gv, ga = tm.ltx_apply(model, TCFG, mods["video"][1], mods["audio"][1])
    assert (gv is None) == (rv is None) and (ga is None) == (ra is None)
    if rv is not None:
        assert _rel(gv, rv) <= FWD_BAR
    if ra is not None:
        assert _rel(ga, ra) <= FWD_BAR


def test_audio_only_model_has_no_video_parameters(av):
    _, _, audio_only = av
    names = set(audio_only.state_dict())
    assert names and all(n.startswith("audio.") or n.split(".")[2].startswith("audio_") for n in names)
    assert not hasattr(audio_only, "video") and not hasattr(audio_only, "av")
    with pytest.raises(ValueError, match="Video is not enabled"):
        tm.ltx_apply(audio_only, TAO_CFG, tm.Modality(torch.zeros(1, 2, 16), torch.zeros(1, 1), torch.zeros(1, 1, 48),
                                                     positions=torch.zeros(1, 3, 2, 2)))


def _loop_inputs(seed: int, f: int = 2, h: int = 4, w: int = 4, t: int = 6):
    rng = np.random.default_rng(seed)
    return dict(
        latents=rng.normal(size=(1, CFG.in_channels, f, h, w)).astype(np.float32),
        positions=create_position_grid(1, f, h, w),
        context=rng.normal(size=(1, 5, CFG.caption_channels)).astype(np.float32),
        neg_context=rng.normal(size=(1, 5, CFG.caption_channels)).astype(np.float32),
        audio_latents=rng.normal(size=(1, 8, t, 16)).astype(np.float32),
        audio_positions=create_audio_position_grid(1, t),
        audio_context=rng.normal(size=(1, 7, CFG.audio_caption_channels)).astype(np.float32),
        audio_neg_context=rng.normal(size=(1, 7, CFG.audio_caption_channels)).astype(np.float32),
    )


def _min_frame_psnr(got: np.ndarray, ref: np.ndarray) -> float:
    peak = float(np.abs(ref).max())
    return min(psnr(got[:, :, i], ref[:, :, i], peak) for i in range(ref.shape[2]))


def _whole_psnr(got: np.ndarray, ref: np.ndarray) -> float:
    return psnr(got, ref, float(np.abs(ref).max()))


@pytest.mark.parametrize("cfg_mode", ["distilled", "batched", "sequential"])
def test_joint_denoise_matches(av, cfg_mode):
    model, params, _ = av
    x = _loop_inputs(5)
    sigmas = subsample_sigmas(STAGE_1_SIGMAS, 3, "farthest")
    kw = dict(cfg_scale=1.0 if cfg_mode == "distilled" else 3.0, cfg_sequential=cfg_mode == "sequential")
    if cfg_mode == "distilled":
        x["neg_context"] = x["audio_neg_context"] = None
    j = {k: None if v is None else jnp.asarray(v) for k, v in x.items()}
    t = {k: None if v is None else torch.from_numpy(v) for k, v in x.items()}
    rv, ra = jdn.denoise(params, CFG, j.pop("latents"), j.pop("positions"), j.pop("context"), sigmas, **j, **kw)
    gv, ga = tdn.denoise(model, TCFG, t.pop("latents"), t.pop("positions"), t.pop("context"), sigmas, **t, **kw)
    assert _min_frame_psnr(gv.numpy(), np.asarray(rv)) >= 35.0
    assert _whole_psnr(ga.numpy(), np.asarray(ra)) >= 35.0


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0])
def test_denoise_audio_only_matches(av, cfg_scale):
    _, params, audio_only = av
    x = _loop_inputs(6)
    sigmas = subsample_sigmas(STAGE_1_SIGMAS, 4, "farthest")
    keys = ("audio_latents", "audio_positions", "audio_context")
    ref = jdn.denoise_audio_only(_jax(_audio_only_tree(jax.tree.map(np.asarray, params))), AO_CFG,
                                 *(jnp.asarray(x[k]) for k in keys), sigmas,
                                 audio_neg_context=jnp.asarray(x["audio_neg_context"]), cfg_scale=cfg_scale)
    got = tdn.denoise_audio_only(audio_only, TAO_CFG, *(torch.from_numpy(x[k]) for k in keys), sigmas,
                                 audio_neg_context=torch.from_numpy(x["audio_neg_context"]), cfg_scale=cfg_scale)
    assert got.shape == (1, 8, 6, 16)
    assert _whole_psnr(got.numpy(), np.asarray(ref)) >= 35.0


# --- the audio VAE decoder, the vocoder, decode_audio ---

def _audio_decoder(seed: int, **kw):
    cfg = taudio.AudioVAEConfig(**{**AVAE, **kw})
    dec = taudio.init_audio_decoder(torch.Generator().manual_seed(seed), cfg, device="cpu", dtype=torch.float32)
    _randomize_(dec, seed)
    with torch.no_grad():
        dec.per_channel_statistics.std_of_means.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(seed))
    return dec, cfg, jaudio.AudioVAEConfig(**{**AVAE, **kw})


def _vocoder(seed: int, **kw):
    cfg = tvoc.VocoderConfig(**VOC, **kw)
    voc = _randomize_(tvoc.init_vocoder(torch.Generator().manual_seed(seed), cfg, device="cpu", dtype=torch.float32),
                      seed)
    return voc, cfg, jvoc.VocoderConfig(**VOC, **kw)


def _close(got: torch.Tensor, ref) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["default", "attention", "t1"])
def test_audio_decoder_matches(case):
    """The narrow decoder, with the mid and up-stage attention blocks the
    config can ask for, and at T = 1 (4T - 3 clamps to 1 frame)."""
    kw = dict(mid_block_add_attention=True, decoder_attn_resolutions=(128,)) if case == "attention" else {}
    dec, cfg, jcfg = _audio_decoder(7, **kw)
    t = 1 if case == "t1" else 5
    z = np.random.default_rng(8).normal(size=(2, 8, t, 16)).astype(np.float32)
    ref = jaudio.audio_decoder_apply(_jax(jax_bridge.audio_decoder_to_jax_tree(dec)), jcfg, jnp.asarray(z))
    got = taudio.audio_decoder_apply(dec, cfg, torch.from_numpy(z))
    assert got.shape == (2, 2, max(4 * t - 3, 1), 64)
    _close(got, ref)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_vocoder_matches(resblock):
    """The default multi-receptive-field blocks (resblock 1, two convs a
    dilation) and the config's other kind (one conv a dilation)."""
    voc, cfg, jcfg = _vocoder(9, resblock=resblock)
    spec = np.random.default_rng(10).normal(size=(1, 2, 9, 64)).astype(np.float32)
    ref = jvoc.vocoder_apply(_jax(jax_bridge.vocoder_to_jax_tree(voc)), jcfg, jnp.asarray(spec))
    got = tvoc.vocoder_apply(voc, cfg, torch.from_numpy(spec))
    assert got.shape == (1, 2, 240 * 9)
    _close(got, ref)


@pytest.mark.parametrize("b", [1, 2])
def test_decode_audio_matches(b):
    dec, dcfg, jdcfg = _audio_decoder(11)
    voc, vcfg, jvcfg = _vocoder(12)
    t = 6
    z = np.random.default_rng(13).normal(size=(b, 8, t, 16)).astype(np.float32)
    ref = jvoc.decode_audio(jnp.asarray(z), _jax(jax_bridge.audio_decoder_to_jax_tree(dec)), jdcfg,
                            _jax(jax_bridge.vocoder_to_jax_tree(voc)), jvcfg)
    got = tvoc.decode_audio(torch.from_numpy(z), dec, dcfg, voc, vcfg)
    assert got.dtype == torch.float32 and got.shape == ((2,) if b == 1 else (b, 2)) + (240 * (4 * t - 3),)
    _close(got, ref)


def test_bridge_round_trips_the_audio_modules():
    dec, cfg, _ = _audio_decoder(14, mid_block_add_attention=True)
    voc, vcfg, _ = _vocoder(15)
    back = taudio.AudioDecoder(cfg, dtype=torch.float32)
    jax_bridge.load_jax_params(back, jax_bridge.audio_decoder_to_jax_tree(dec), stacked=())
    voc_back = tvoc.Vocoder(vcfg, dtype=torch.float32)
    voc_back.load_state_dict(jax_bridge.vocoder_state_dict(jax_bridge.vocoder_to_jax_tree(voc)))
    for a, b in ((dec, back), (voc, voc_back)):
        for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), name


# --- the composed pipelines against JAX ---

H = W = 128  # the distilled pipeline's multiple of 64: stage 1 at 64 x 64


@pytest.fixture(scope="module")
def parts(av):
    model, params, audio_only = av
    rng = np.random.default_rng(30)
    decoder = tdec.init_video_decoder(torch.Generator().manual_seed(31), tdec.DecoderConfig(**DEC_KW), device="cpu")
    upsampler = tups.init_latent_upsampler(torch.Generator().manual_seed(32), 16, 32, 1, device="cpu")
    encoder = _encoder(33)
    adec, acfg, jacfg = _audio_decoder(34)
    voc, vcfg, jvcfg = _vocoder(35)
    emb = {name: torch.from_numpy(rng.normal(size=(1, 8, 48)).astype(np.float32))
           for name in ("video", "video_neg", "audio", "audio_neg")}
    port = tgen.ModelBundle(model, TCFG, decoder, tdec.DecoderConfig(**DEC_KW), upsampler, encoder,
                            tconfig.VideoVAEConfig(**ENC_KW), audio_decoder=adec, audio_decoder_config=acfg,
                            vocoder=voc, vocoder_config=vcfg, audio_transformer=audio_only,
                            audio_transformer_config=TAO_CFG)
    np_params = jax.tree.map(np.asarray, params)
    jax_bundle = jgen.ModelBundle(
        params, CFG, _jax(jax_bridge.module_to_jax_tree(decoder)), JaxDecoderConfig(**DEC_KW),
        vae_encoder_params=_jax(jax_bridge.encoder_to_jax_tree(encoder)), vae_encoder_config=JaxVAEConfig(**ENC_KW),
        upsampler_params=_jax(jax_bridge.module_to_jax_tree(upsampler)),
        audio_decoder_params=_jax(jax_bridge.audio_decoder_to_jax_tree(adec)), audio_decoder_config=jacfg,
        vocoder_params=_jax(jax_bridge.vocoder_to_jax_tree(voc)), vocoder_config=jvcfg,
        audio_transformer_params=_jax(_audio_only_tree(np_params)), audio_transformer_config=AO_CFG,
    )
    return port, jax_bundle, emb


class _JaxDraws:
    """Stands in for ``torch.randn``: returns JAX's draws in order and checks
    each requested shape."""

    def __init__(self, draws):
        self.draws = [np.array(d, np.float32) for d in draws]

    def __call__(self, size, *, generator=None, device=None, dtype=None):
        want = self.draws.pop(0)
        assert tuple(size) == want.shape
        return torch.from_numpy(want).to(device=device, dtype=dtype)


def _read_wav(path) -> np.ndarray:
    with wave.open(str(path), "rb") as wf:
        assert wf.getframerate() == 24000 and wf.getnchannels() == 2
        return np.frombuffer(wf.readframes(wf.getnframes()), np.int16).reshape(-1, 2).T.astype(np.float32) / 32767


# (pipeline, audio mode, the JAX keys of the draws in the port's order)
RUNS = {
    "joint_distilled": ("distilled", "joint", (0, 5, 1, 6, 2)),
    "separate_distilled_image": ("distilled", "separate", (0, 1, 7, 2)),
    "joint_dev_cfg": ("dev", "joint", (0, 5, 2)),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_generate_video_with_audio_matches_jax(monkeypatch, tmp_path, parts, run):
    port, jax_bundle, emb = parts
    pipeline, mode, key_ids = RUNS[run]
    seed, num_frames, dev = 4, 9, pipeline == "dev"
    images = [(_write_png(tmp_path / "cond.png", H, 40), 0, 1.0)] if "image" in run else []
    kw = dict(height=H, width=W, num_frames=num_frames, seed=seed, tiling="none", video_encoder="cv2",
              audio=True, audio_mode=mode, images=images)
    kw.update(num_inference_steps=2, cfg_scale=3.0) if dev else kw.update(stage1_steps=2, stage2_steps=1,
                                                                           audio_steps=2)
    neg = dev
    jtext = jgen.TextConditioning(*(jnp.asarray(emb[k].numpy()) if neg or "neg" not in k else None
                                    for k in ("video", "video_neg", "audio", "audio_neg")))
    ref = jgen.generate_video(jax_bundle, jtext, dtype=jnp.float32, output_path=tmp_path / "jax.mp4",
                              **{**kw, "pipeline": jgen.PipelineType(pipeline)})
    keys = jax.random.split(jax.random.key(seed), 8)
    frames = 1 + (num_frames - 1) // 8
    t = ref.audio_latents.shape[2]
    scale = 32 if dev else 64
    shapes = {0: (1, 16, frames, H // scale, W // scale), 1: (1, 16, frames, H // 32, W // 32),
              5: (1, 8, t, 16), 6: (1, 8, t, 16), 7: (1, 8, t, 16)}
    draws = []
    for k in key_ids:
        if k == 2:
            cl = jax.random.normal(keys[2], (1, frames, H // 32, W // 32, 16), dtype=jnp.float32)
            draws.append(np.transpose(np.asarray(cl), (0, 4, 1, 2, 3)))
        else:
            draws.append(jax.random.normal(keys[k], shapes[k], dtype=jnp.float32))
    draws = _JaxDraws(draws)
    monkeypatch.setattr(torch, "randn", draws)
    got = tgen.generate_video(port, tgen.TextConditioning(*(emb[k] if neg or "neg" not in k else None
                                                            for k in ("video", "video_neg", "audio", "audio_neg"))),
                              dtype=torch.float32, output_path=tmp_path / "port.mp4", pipeline=pipeline, **kw)
    monkeypatch.undo()
    assert draws.draws == []
    assert t == 9 and got.audio_latents.shape == ref.audio_latents.shape == (1, 8, 9, 16)
    assert _min_frame_psnr(got.latents, ref.latents) >= 35.0
    assert _whole_psnr(got.audio_latents, ref.audio_latents) >= 35.0
    assert min(psnr(got.video[:, :, i], ref.video[:, :, i], 2.0) for i in range(num_frames)) >= 35.0
    assert got.audio_path == tmp_path / "port.wav" and got.audio.shape == (2, 240 * (4 * t - 3))
    port_wav, jax_wav = _read_wav(tmp_path / "port.wav"), _read_wav(tmp_path / "jax.wav")
    assert port_wav.shape == jax_wav.shape == (2, 240 * (4 * t - 3))
    assert psnr(port_wav, jax_wav, 2.0) >= 35.0
    assert got.video_path == tmp_path / "port.mp4" and (tmp_path / "port.mp4").stat().st_size > 0
    assert not (tmp_path / "port.temp.mp4").exists()
    assert set(got.phase_seconds) >= {"audio_decode", "audio_mux"} | ({"audio_denoise"} if mode == "separate" else set())


def test_generate_video_audio_refusals(parts):
    port, _, emb = parts
    text = tgen.TextConditioning(emb["video"], audio_embeddings=emb["audio"])
    with pytest.raises(ValueError, match="num_videos > 1"):
        tgen.generate_video(port, text, height=H, width=W, num_frames=9, num_videos=2, audio=True,
                            dtype=torch.float32, decode_latents_only=True)
    with pytest.raises(ValueError, match="audio_neg_embeddings"):
        tgen.generate_video(port, tgen.TextConditioning(emb["video"], emb["video_neg"], emb["audio"]), height=H,
                            width=W, num_frames=9, stage1_steps=1, stage2_steps=1, stage2_cfg=True, audio=True,
                            audio_mode="joint", dtype=torch.float32, decode_latents_only=True)
    video_only = dataclasses.replace(port, transformer_config=tconfig.LTXModelConfig.from_dict(
        dataclasses.replace(CFG, model_type=LTXModelType.VideoOnly).to_dict()))
    with pytest.raises(ValueError, match="AudioVideo"):
        tgen.generate_video(video_only, text, audio=True, audio_mode="joint", dtype=torch.float32)
    with pytest.raises(ValueError, match="AudioOnly"):
        tgen.generate_video(dataclasses.replace(port, audio_transformer=None), text, height=H, width=W,
                            num_frames=9, stage1_steps=1, stage2_steps=1, audio=True, dtype=torch.float32)


@pytest.mark.parametrize("ffmpeg", [False, True])
def test_generate_video_audio_paths(parts, tmp_path, monkeypatch, ffmpeg):
    """``output_audio_path`` sets the WAV's path; with ffmpeg the mux
    replaces the silent video (mux_audio stood in for here), without it
    the silent video is moved to the output path."""
    port, _, emb = parts
    muxed = []

    def mux(video, wav, out, **kw):
        muxed.append((video, wav, out, kw))
        if ffmpeg:
            out.write_bytes(b"muxed")
        return ffmpeg

    monkeypatch.setattr(tgen.media, "mux_audio", mux)
    res = tgen.generate_video(port, tgen.TextConditioning(emb["video"], audio_embeddings=emb["audio"]), height=H,
                              width=W, num_frames=9, stage1_steps=1, stage2_steps=1, audio_steps=1, audio=True,
                              dtype=torch.float32, tiling="none", video_encoder="cv2",
                              output_path=tmp_path / "o.mp4", output_audio_path=tmp_path / "a.wav",
                              audio_filter="volume=2", audio_bitrate="128k")
    assert res.audio_path == tmp_path / "a.wav" and (tmp_path / "a.wav").exists()
    (video, wav, out, kw), = muxed
    assert (video, wav, out) == (tmp_path / "o.temp.mp4", tmp_path / "a.wav", tmp_path / "o.mp4")
    assert kw == dict(audio_filter="volume=2", audio_bitrate="128k", audio_sample_rate=24000)
    assert (tmp_path / "o.mp4").exists() and not (tmp_path / "o.temp.mp4").exists()
    assert ((tmp_path / "o.mp4").read_bytes() == b"muxed") == ffmpeg


# --- loaders ---

def _conv_nested(name: str) -> str:
    """A port decoder name as the reference checkpoint nests it: the convs
    of CausalConv2d wrappers one level deeper (``conv1.conv.weight``)."""
    parts = name.split(".")
    if parts[-1] in ("weight", "bias") and parts[-2] in ("conv1", "conv2", "nin_shortcut", "conv_in", "conv_out",
                                                         "conv"):
        parts.insert(len(parts) - 1, "conv")
    return ".".join(parts)


@pytest.mark.parametrize("stats", ["std_of_means", "std-of-means", "_std_of_means"])
def test_load_audio_vae_weights_matches_jax(tmp_path, stats):
    dec, cfg, jcfg = _audio_decoder(40)
    mean_name = stats.replace("std", "mean")
    state = {("decoder." + _conv_nested(k)): v.numpy() for k, v in dec.state_dict().items()
             if not k.startswith("per_channel_statistics")}
    state[f"per_channel_statistics.{stats}"] = dec.per_channel_statistics.std_of_means.numpy()
    state[f"per_channel_statistics.{mean_name}"] = dec.per_channel_statistics.mean_of_means.numpy()
    save_safetensors(tmp_path / "a.safetensors", state)
    ref = jaudio.init_audio_decoder(jax.random.key(0), jcfg, dtype=jnp.float32)
    jvae.load_audio_vae_weights(tmp_path / "a.safetensors", None, ref, dtype=jnp.float32)
    got = taudio.init_audio_decoder(torch.Generator().manual_seed(1), cfg, device="cpu", dtype=torch.float32)
    assert tvae.load_audio_vae_weights(tmp_path / "a.safetensors", got) == len(got.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax_bridge.audio_decoder_to_jax_tree(got)):
        want = ref
        for p in path:
            want = want[p.key]
        np.testing.assert_array_equal(leaf, np.asarray(want))
    del state["decoder.up.1.block.0.conv2.conv.bias"]
    save_safetensors(tmp_path / "b.safetensors", state)
    with pytest.raises(ValueError, match="1 parameters not in the file"):
        tvae.load_audio_vae_weights(tmp_path / "b.safetensors", got)


@pytest.mark.parametrize("prefix", ["vocoder.", ""])
def test_load_vocoder_weights_matches_jax(tmp_path, prefix):
    voc, cfg, jcfg = _vocoder(41)
    state = {prefix + k: v.numpy() for k, v in voc.state_dict().items()}
    save_safetensors(tmp_path / "v.safetensors", state)
    ref = jvoc.init_vocoder(jax.random.key(0), jcfg, dtype=jnp.float32)
    jvae.load_vocoder_weights(tmp_path / "v.safetensors", ref, dtype=jnp.float32)
    got = tvoc.init_vocoder(torch.Generator().manual_seed(1), cfg, device="cpu", dtype=torch.float32)
    assert tvae.load_vocoder_weights(tmp_path / "v.safetensors", got) == len(got.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax_bridge.vocoder_to_jax_tree(got)):
        want = ref
        for p in path:
            want = want[p.key]
        np.testing.assert_array_equal(leaf, np.asarray(want))
    del state[prefix + "resblocks.4.convs2.1.weight"]
    save_safetensors(tmp_path / "w.safetensors", state)
    with pytest.raises(ValueError, match="1 parameters not in the file"):
        tvae.load_vocoder_weights(tmp_path / "w.safetensors", got)


_DESANITIZE = ((".to_out.", ".to_out.0."), (".audio_ff.proj_in.", ".audio_ff.net.0.proj."),
               (".audio_ff.proj_out.", ".audio_ff.net.2."), (".ff.proj_in.", ".ff.net.0.proj."),
               (".ff.proj_out.", ".ff.net.2."), (".linear1.", ".linear_1."), (".linear2.", ".linear_2."))


def _mlx_key(name: str) -> str:
    """Port state name -> sanitized MLX key (packed words under ``.weight``)."""
    head, _, rest = name.partition(".")
    key = {"blocks": "transformer_blocks." + rest, "video": rest, "audio": "audio_" + rest}.get(head)
    if head == "av":
        adaln, _, leaf = rest.partition(".")
        key = f"{adaln}_single.{leaf}"
    return key[: -len("quant_weight")] + "weight" if key.endswith(".quant_weight") else key


def _pt_key(name: str) -> str:
    key = _mlx_key(name)
    for sanitized, raw in _DESANITIZE:
        key = key.replace(sanitized, raw)
    return "model.diffusion_model." + key


def _np_bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


def _same_tree(ref: dict, ours: dict) -> None:
    ref = jax.tree.map(np.asarray, ref)
    assert jax.tree.structure(ref) == jax.tree.structure(ours)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        got = ours
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(np.asarray(got), leaf)


@pytest.mark.parametrize("layout", ["pytorch", "mlx_q4", "unified"])
def test_av_checkpoint_loads_as_jax_loads_it(av, tmp_path, layout):
    """AudioVideo files in three layouts: the AudioVideo skeleton strictly,
    the AudioOnly and VideoOnly ones their parts (JAX's strict=False)."""
    model, params, _ = av
    src = tm.LTXModel(TCFG, device="cpu", dtype=torch.float32)
    tree = jax.tree.map(np.asarray, params)
    if layout == "mlx_q4":
        tree = jax.tree.map(np.asarray, jquant.quantize_dit_params(params))
    jax_bridge.load_jax_params(src, tree)
    path = tmp_path / "dit.safetensors"
    if layout == "unified":
        build_unified_bundle(path, tree, include_audio=False)
        load = dict(fn=tweights.load_native_params, prefix="transformer.")
        ref_of = lambda cfg: jweights.load_native_params(path, prefix="transformer.")  # noqa: E731
    else:
        key = _pt_key if layout == "pytorch" else _mlx_key
        save_safetensors(path, {key(k): _np_bits(v) for k, v in src.state_dict().items()})
        load = dict(fn=tweights.load_dit_params)
        ref_of = lambda cfg: jweights.load_dit_params(path, cfg, dtype=jnp.float32, strict=False)  # noqa: E731
    fn = load.pop("fn")
    arg = path if layout == "unified" else [path]
    ours = fn(arg, TCFG, dtype=torch.float32, device="cpu", **load)
    assert sum(isinstance(m, QuantLinear) for m in ours.modules()) == (28 * CFG.num_layers if layout == "mlx_q4" else 0)
    _same_tree(ref_of(CFG), jax_bridge.module_to_jax_tree(ours))
    audio_only = fn(arg, TAO_CFG, dtype=torch.float32, device="cpu", **load)
    want = ref_of(AO_CFG)
    if layout == "unified":  # the native file holds the whole tree: its audio part
        want = _audio_only_tree(jax.tree.map(np.asarray, want))
    _same_tree(want, jax_bridge.module_to_jax_tree(audio_only))
    video_cfg = dataclasses.replace(CFG, model_type=LTXModelType.VideoOnly)
    video = fn(arg, tconfig.LTXModelConfig.from_dict(video_cfg.to_dict()), dtype=torch.float32, device="cpu", **load)
    assert not hasattr(video, "audio") and sum(isinstance(m, QuantLinear) for m in video.modules()) == (
        10 * CFG.num_layers if layout == "mlx_q4" else 0)


def test_av_checkpoint_strict_on_the_av_skeleton(av, tmp_path):
    model, _, _ = av
    state = {_mlx_key(k): v.numpy() for k, v in model.state_dict().items()}
    del state["transformer_blocks.1.video_to_audio_attn.to_k.weight"]
    del state["av_ca_a2v_gate_adaln_single.linear.bias"]
    save_safetensors(tmp_path / "m.safetensors", state)
    with pytest.raises(ValueError, match="Missing 2 parameters"):
        tweights.load_dit_params(tmp_path / "m.safetensors", TCFG, dtype=torch.float32, device="cpu")
    audio_only = tweights.load_dit_params(tmp_path / "m.safetensors", TAO_CFG, dtype=torch.float32, device="cpu")
    assert not any(isinstance(m, QuantLinear) for m in audio_only.modules())


def test_dit_tree_path_maps_the_audio_and_av_names():
    for key in ("audio_patchify_proj.weight", "audio_adaln_single.emb.timestep_embedder.linear1.bias",
                "av_ca_v2a_gate_adaln_single.linear.weight", "transformer_blocks.0.audio_to_video_attn.to_q.weight",
                "audio_norm_out.weight", "norm_out.weight", "audio_scale_shift_table"):
        mapped = jweights.dit_tree_path(key)
        want = None
        if mapped is not None:
            layer, path = mapped
            want = ".".join(path[:1] + ((str(layer),) if layer is not None else ()) + path[1:])
        assert tweights.dit_tree_path(key) == want, key


@pytest.mark.parametrize("mode", ["q4", "w8a8", "w4a8"])
def test_quantize_models_picks_jax_scopes_on_an_av_model(av, mode):
    model, params, _ = av
    ours = tm.LTXModel(TCFG, device="cpu", dtype=torch.float32)
    ours.load_state_dict(model.state_dict())
    bundle = tgen.ModelBundle(ours, TCFG, None, None)
    kw = {"q4": dict(quantize_bits=4), "w8a8": dict(w8a8=True), "w4a8": dict(w4a8=True)}[mode]
    tloading.quantize_models(bundle, **kw)
    if mode == "w8a8":
        ref = jint8.quantize_params_w8a8(params)
        leaf = "int8_weight"
    else:
        ref = jquant.quantize_dit_params(params, bits=4)
        if mode == "w4a8":
            ref = jquant.prepare_w4a8(ref, bits=4)
        leaf = "int8_scale" if mode == "w4a8" else "quant_weight"
    want = {".".join(str(p.key) for p in path[:-1]) for path, _ in jax.tree_util.tree_leaves_with_path(ref)
            if path[-1].key == leaf}
    kind = Int8Linear if mode == "w8a8" else QuantLinear
    got = {re.sub(r"^blocks\.\d+\.", "blocks.", name) for name, m in ours.named_modules() if isinstance(m, kind)}
    assert got == want and len(got) == 28
    assert sum(isinstance(m, kind) for m in ours.modules()) == 28 * CFG.num_layers


def test_merge_lora_on_the_audio_linears_matches_jax(av, tmp_path, capsys):
    model, params, _ = av
    rng = np.random.default_rng(50)
    lins = [("audio_attn1.to_q", 64, 64), ("audio_ff.net.0.proj", 64, 256), ("audio_to_video_attn.to_k", 64, 64),
            ("video_to_audio_attn.to_out.0", 64, 64), ("attn1.to_v", 128, 128)]
    state = {}
    for i in (0, 1):
        for lin, n_in, n_out in lins:
            key = f"diffusion_model.transformer_blocks.{i}.{lin}"
            state[f"{key}.lora_A.weight"] = rng.normal(size=(4, n_in)).astype(np.float32) * 0.1
            state[f"{key}.lora_B.weight"] = rng.normal(size=(n_out, 4)).astype(np.float32) * 0.1
    save_safetensors(tmp_path / "a.safetensors", state)
    ref = jlora.merge_lora_into_params(jax.tree.map(jnp.asarray, params),
                                       [jlora.LoraSpec(tmp_path / "a.safetensors", 0.7)], verbose=True)
    ref_counts = capsys.readouterr().out
    merged = tlora.merge_lora_into_params(model, [tlora.LoraSpec(tmp_path / "a.safetensors", 0.7)], verbose=True)
    assert capsys.readouterr().out.split()[-2:] == ref_counts.split()[-2:] == ["applied=10", "skipped=0"]
    ours = jax_bridge.module_to_jax_tree(merged)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        got = ours
        for p in path:
            got = got[p.key]
        np.testing.assert_allclose(got, np.asarray(leaf), rtol=0, atol=1e-6)


def test_generate_video_without_an_audio_decoder_still_writes_the_video(parts, tmp_path):
    """Audio asked for and no audio decoder: no WAV, and the video lands at
    the output path, not at the silent temporary one (as in JAX)."""
    port, _, emb = parts
    res = tgen.generate_video(dataclasses.replace(port, audio_decoder=None),
                              tgen.TextConditioning(emb["video"], audio_embeddings=emb["audio"]), height=H, width=W,
                              num_frames=9, stage1_steps=1, stage2_steps=1, audio_steps=1, audio=True,
                              dtype=torch.float32, tiling="none", video_encoder="cv2", output_path=tmp_path / "o.mp4")
    assert res.video_path == tmp_path / "o.mp4" and (tmp_path / "o.mp4").stat().st_size > 0
    assert res.audio is None and res.audio_path is None and res.audio_latents.shape == (1, 8, 9, 16)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["o.mp4"]
