"""The port's distilled pipeline against the JAX package, on the CPU.

The composed test runs stage 1 (2 steps), the 2x upsample, the renoise and
stage 2 (1 step) in both frameworks on shared weights and shared noise, then
a tiled decode, and gates per-frame latent and RGB PSNR at >= 35 dB, the gate
of tests/test_torch_cross_pipeline.py. The remaining tests run the port's
``generate_video`` end to end at a tiny size, and once in a process where
JAX and ml_dtypes cannot be imported (distilled, dev with an image and both
kernel routes on, keyframe with a LoRA-merged stage-2 copy and stage-2 CFG,
streamed, a batch of two videos, joint and separate audio to a WAV, q4, a
training step, W8A8, a W8A8 text encoder on token ids and the int8
attention's plain version).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_video_tpu.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu.models.ltx.upsampler import upsample_latents
from mlx_video_tpu.models.ltx.video_vae.decoder import DecoderConfig as JaxDecoderConfig
from mlx_video_tpu.models.ltx.video_vae.tiling import TilingConfig
from mlx_video_tpu.pipelines import denoise as jdn
from mlx_video_tpu.pipelines import generate as jgen
from mlx_video_tpu.pipelines.positions import create_position_grid
from mlx_video_tpu.pipelines.schedulers import (
    STAGE_1_SIGMAS,
    STAGE_2_SIGMAS,
    subsample_refinement_sigmas,
    subsample_sigmas,
)
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.models.ltx import upsampler as tups
from mlx_video_tpu_torch.models.ltx.video_vae import decoder as tdec
from mlx_video_tpu_torch.pipelines import denoise as tdn
from mlx_video_tpu_torch.pipelines import generate as tgen

REPO = Path(__file__).resolve().parent.parent
DEC_KW = dict(in_channels=16, base_channels=32, num_layers_per_block=1, num_upsamples=3, patch_size=4)


def psnr(a: np.ndarray, b: np.ndarray, peak: float) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


@pytest.mark.parametrize("sigma, sigma_next", [(0.909375, 0.725), (0.421875, 0.0)])
def test_euler_step_matches(rng, sigma, sigma_next):
    lat = rng.normal(size=(1, 4, 2, 2, 2)).astype(np.float32)
    den = rng.normal(size=lat.shape).astype(np.float32)
    ref = jdn._euler_step(jnp.asarray(lat), jnp.asarray(den), jnp.float32(sigma), jnp.float32(sigma_next))
    got = tdn._euler_step(torch.from_numpy(lat), torch.from_numpy(den),
                          float(np.float32(sigma)), float(np.float32(sigma_next)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("frames", [1, 9, 33, 34, 100])
def test_frame_and_dimension_rounding_matches(frames):
    assert tgen.round_frames(frames) == jgen.round_frames(frames)
    for h, w in [(512, 512), (500, 768), (100, 37)]:
        assert tgen.pad_dimensions(h, w, 64) == jgen.pad_dimensions(h, w, 64)


@pytest.mark.parametrize("mode", ["auto", "none", "default", "spatial", "temporal", "aggressive"])
def test_select_tiling_matches(mode):
    for h, w, f in [(512, 512, 33), (768, 1024, 121)]:
        got, ref = tgen.select_tiling(mode, h, w, f), jgen.select_tiling(mode, h, w, f, stream=False)
        assert (got is None and ref is None) or dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_composed_pipeline_psnr_gate():
    # shared weights: the port's init, handed to JAX through the bridge
    models = _tiny_models(seed=7)
    cfg = models.transformer_config
    jcfg = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)
    rng = np.random.default_rng(7)
    decoder = models.vae_decoder
    decoder.latents_mean.copy_(torch.from_numpy(rng.normal(size=(16,)).astype(np.float32) * 0.2))
    decoder.latents_std.copy_(torch.from_numpy(rng.uniform(0.8, 1.5, size=(16,)).astype(np.float32)))
    params, dec_params, ups_params = (
        jax.tree.map(jnp.asarray, jax_bridge.module_to_jax_tree(m))
        for m in (models.transformer, decoder, models.upsampler)
    )
    dec_cfg = JaxDecoderConfig(**DEC_KW)

    b, f0, h0, w0 = 1, 2, 2, 2
    latents0 = rng.normal(size=(b, 16, f0, h0, w0)).astype(np.float32)
    context = rng.normal(size=(b, 8, cfg.caption_channels)).astype(np.float32)
    renoise = rng.normal(size=(b, 16, f0, 2 * h0, 2 * w0)).astype(np.float32)
    s1 = subsample_sigmas(STAGE_1_SIGMAS, 2, "farthest")
    s2 = subsample_refinement_sigmas(STAGE_2_SIGMAS, 1, "farthest")
    pos1 = create_position_grid(b, f0, h0, w0)
    pos2 = create_position_grid(b, f0, 2 * h0, 2 * w0)
    tiling = TilingConfig.spatial_only(tile_size=64, overlap=32)

    # JAX
    v1, _ = jdn.denoise(params, jcfg, jnp.asarray(latents0), jnp.asarray(pos1), jnp.asarray(context), s1)
    up = upsample_latents(ups_params, v1, dec_params["latents_mean"], dec_params["latents_std"])
    lat2 = jnp.asarray(renoise) * s2[0] + up * (1.0 - s2[0])
    v2, _ = jdn.denoise(params, jcfg, lat2, jnp.asarray(pos2), jnp.asarray(context), s2)
    jax_latent = np.asarray(v2, np.float32)
    jax_models = jgen.ModelBundle(None, jcfg, dec_params, dec_cfg)
    jax_rgb = jgen.decode_latents(jax_models, v2, tiling, decode_timestep=0.05)

    # port, on the same weights and noise
    ctx = torch.from_numpy(context)
    t1, _ = tdn.denoise(models.transformer, cfg, torch.from_numpy(latents0), torch.from_numpy(pos1), ctx, s1)
    tup = tups.upsample_latents(models.upsampler, t1, decoder.latents_mean, decoder.latents_std)
    t2, _ = tdn.denoise(models.transformer, cfg, torch.from_numpy(renoise) * s2[0] + tup * (1.0 - s2[0]),
                     torch.from_numpy(pos2), ctx, s2)
    rgb = tgen.decode_latents(models, t2, tiling, decode_timestep=0.05)

    assert t2.shape == (b, 16, f0, 4, 4) and rgb.shape == jax_rgb.shape == (b, 3, 9, 128, 128)
    lat = t2.numpy()
    lat_peak = float(np.abs(jax_latent).max())
    assert min(psnr(lat[:, :, i], jax_latent[:, :, i], lat_peak) for i in range(f0)) >= 35.0
    assert min(psnr(rgb[:, :, i], jax_rgb[:, :, i], 2.0) for i in range(rgb.shape[2])) >= 35.0


def _tiny_models(seed: int = 0) -> tgen.ModelBundle:
    cfg = tconfig.tiny_test_config(tconfig.LTXModelType.VideoOnly, rope_type=tconfig.LTXRopeType.SPLIT)
    g = torch.Generator().manual_seed(seed)
    dec_cfg = tdec.DecoderConfig(**DEC_KW)
    return tgen.ModelBundle(
        transformer=tm.init_ltx_params(cfg, g, device="cpu", dtype=torch.float32),
        transformer_config=cfg,
        vae_decoder=tdec.init_video_decoder(g, dec_cfg, device="cpu"),
        vae_decoder_config=dec_cfg,
        upsampler=tups.init_latent_upsampler(g, 16, 32, 1, device="cpu"),
    )


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)
    text = tgen.TextConditioning(torch.randn(1, 8, cfg.caption_channels, generator=torch.Generator().manual_seed(1)))
    return _tiny_models(), text


def _run(models, text, seed):
    return tgen.generate_video(
        models, text, height=64, width=64, num_frames=9, stage1_steps=2, stage2_steps=1,
        generator=torch.Generator().manual_seed(seed), dtype=torch.float32,
    )


def test_generate_video_end_to_end_is_deterministic(tiny):
    models, text = tiny
    a, b, c = _run(models, text, 3), _run(models, text, 3), _run(models, text, 4)
    assert a.video.shape == (1, 3, 9, 64, 64) and a.latents.shape == (1, 16, 2, 2, 2)
    assert np.isfinite(a.video).all() and a.video.dtype == np.float32
    np.testing.assert_array_equal(a.video, b.video)
    np.testing.assert_array_equal(a.latents, b.latents)
    assert not np.array_equal(a.latents, c.latents)
    assert set(a.phase_seconds) == {"stage1_denoise", "upsample", "stage2_denoise", "vae_decode"}


def test_generate_video_rejects_bad_arguments(tiny):
    models, text = tiny
    with pytest.raises(ValueError, match="stage2_steps"):
        tgen.generate_video(models, text, stage2_steps=4, dtype=torch.float32)
    with pytest.raises(ValueError, match="pipeline dtype"):
        tgen.generate_video(models, text, dtype=torch.bfloat16)


def test_generate_video_writes_mp4(tiny, tmp_path):
    models, text = tiny
    path = tmp_path / "out.mp4"
    res = tgen.generate_video(models, text, height=64, width=64, num_frames=9, stage1_steps=1,
                              stage2_steps=1, output_path=path, dtype=torch.float32)
    assert res.video_path == path and path.stat().st_size > 0


def test_generate_video_latents_only(tiny):
    models, text = tiny
    res = tgen.generate_video(models, text, height=64, width=64, num_frames=9, stage1_steps=1,
                              stage2_steps=1, decode_latents_only=True, dtype=torch.float32)
    assert res.video is None and res.latents.shape == (1, 16, 2, 2, 2)
    assert "vae_decode" not in res.phase_seconds


_NO_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = sys.modules["ml_dtypes"] = sys.modules["flax"] = sys.modules["mlx_video_tpu"] = None
import numpy as np
import torch
import mlx_video_tpu_torch
for info in pkgutil.walk_packages(mlx_video_tpu_torch.__path__, "mlx_video_tpu_torch."):
    importlib.import_module(info.name)
assert "mlx_video_tpu_torch.trainer.trainer" in sys.modules and "mlx_video_tpu_torch.cli.train" in sys.modules
assert {"mlx_video_tpu_torch.ops.int8", "mlx_video_tpu_torch.models.gemma3", "mlx_video_tpu_torch.models.ltx.text_encoder",
        "mlx_video_tpu_torch.io.text_encoder_weights", "mlx_video_tpu_torch.pipelines.prompts",
        "mlx_video_tpu_torch.lora", "mlx_video_tpu_torch.io.media", "mlx_video_tpu_torch.models.ltx.video_vae.tiling",
        "mlx_video_tpu_torch.pipelines.conditioning", "mlx_video_tpu_torch.trainer.precompute",
        "mlx_video_tpu_torch.precompute", "mlx_video_tpu_torch.cli.precompute", "mlx_video_tpu_torch.trainer.aux",
        "mlx_video_tpu_torch.trainer.validation_sampler", "mlx_video_tpu_torch.trainer.model_loader",
        "mlx_video_tpu_torch.models.ltx.audio_vae.processing", "mlx_video_tpu_torch.serve",
        "mlx_video_tpu_torch.cli.serve", "mlx_video_tpu_torch.enhance", "mlx_video_tpu_torch.cli.enhance",
        "mlx_video_tpu_torch.utils.profiling", "mlx_video_tpu_torch.convert", "mlx_video_tpu_torch.cli.convert",
        "mlx_video_tpu_torch.generate_dev", "mlx_video_tpu_torch.io.prefetch", "mlx_video_tpu_torch.utils.debug",
        "mlx_video_tpu_torch.tools.compare_latents", "mlx_video_tpu_torch.postprocess",
        "mlx_video_tpu_torch.parallel.distributed", "mlx_video_tpu_torch.parallel.mesh",
        "mlx_video_tpu_torch.parallel.collectives", "mlx_video_tpu_torch.parallel.sharding",
        "mlx_video_tpu_torch.parallel.ring_attention", "mlx_video_tpu_torch.parallel.pipeline"} <= set(sys.modules)
from mlx_video_tpu_torch.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu_torch.models.ltx.model import init_ltx_params
from mlx_video_tpu_torch.models.ltx.upsampler import init_latent_upsampler
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, init_video_decoder
from mlx_video_tpu_torch.pipelines.generate import ModelBundle, TextConditioning, generate_video
cfg = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)
g = torch.Generator().manual_seed(0)
dec = DecoderConfig(in_channels=16, base_channels=32, num_layers_per_block=1)
models = ModelBundle(init_ltx_params(cfg, g, device="cpu", dtype=torch.float32), cfg,
                     init_video_decoder(g, dec, device="cpu"), dec,
                     init_latent_upsampler(g, 16, 32, 1, device="cpu"))
res = generate_video(models, TextConditioning(torch.zeros(1, 4, cfg.caption_channels)), height=64,
                     width=64, num_frames=9, stage1_steps=1, stage2_steps=1, dtype=torch.float32)
assert res.video.shape == (1, 3, 9, 64, 64)
# the dev pipeline: one image through the VAE encoder, batched CFG, K4 and K5 routes on
import tempfile
from PIL import Image
from mlx_video_tpu_torch.config import VideoVAEConfig
from mlx_video_tpu_torch.models.ltx.video_vae.encoder import init_video_encoder
from mlx_video_tpu_torch.ops.attention import use_cross_kernel, use_fused_rope
blocks = (("res_x", {"num_layers": 1}), ("compress_space_res", {"multiplier": 1}),
          ("compress_time_res", {"multiplier": 1}), ("compress_all_res", {"multiplier": 1}),
          ("compress_all_res", {"multiplier": 1}))
models.vae_encoder_config = VideoVAEConfig(out_channels=16, latent_channels=16, encoder_blocks=blocks)
models.vae_encoder = init_video_encoder(g, models.vae_encoder_config, device="cpu")
use_cross_kernel(True)
use_fused_rope(True)
with tempfile.TemporaryDirectory() as tmp:
    Image.fromarray(np.full((64, 64, 3), 128, np.uint8)).save(f"{tmp}/img.png")
    res = generate_video(models, TextConditioning(torch.zeros(1, 4, cfg.caption_channels),
                                                  torch.ones(1, 4, cfg.caption_channels)),
                         height=64, width=64, num_frames=9, pipeline="dev", num_inference_steps=1, cfg_scale=4.5,
                         images=[(f"{tmp}/img.png", 0, 1.0)], dtype=torch.float32)
assert res.video.shape == (1, 3, 9, 64, 64) and set(res.phase_seconds) == {"cond_encode", "dev_denoise", "vae_decode"}
use_cross_kernel(False)
use_fused_rope(False)
# the keyframe pipeline, streamed, with stage-2 CFG on a LoRA-merged stage-2 copy; then two videos in one batch
from mlx_video_tpu_torch.io.safetensors import save_safetensors
from mlx_video_tpu_torch.lora import LoraSpec, merge_lora_into_params
with tempfile.TemporaryDirectory() as tmp:
    Image.fromarray(np.full((64, 64, 3), 90, np.uint8)).save(f"{tmp}/key.png")
    key = "diffusion_model.transformer_blocks.0.attn1.to_q"
    save_safetensors(f"{tmp}/lora.safetensors", {f"{key}.lora_A.weight": torch.ones(2, cfg.inner_dim),
                                                 f"{key}.lora_B.weight": torch.full((cfg.inner_dim, 2), 0.01)})
    models.stage2_transformer = merge_lora_into_params(models.transformer, [LoraSpec(f"{tmp}/lora.safetensors", 0.5)])
    res = generate_video(models, TextConditioning(torch.zeros(1, 4, cfg.caption_channels),
                                                  torch.ones(1, 4, cfg.caption_channels)),
                         height=64, width=64, num_frames=9, pipeline="keyframe", stage1_steps=1, stage2_steps=1,
                         stage2_cfg=True, images=[(f"{tmp}/key.png", 0, 1.0)], stream=True,
                         output_path=f"{tmp}/k.mp4", video_encoder="cv2", dtype=torch.float32)
    assert res.video.shape == (1, 3, 9, 64, 64)
models.stage2_transformer = None
res = generate_video(models, TextConditioning(torch.zeros(1, 4, cfg.caption_channels)), height=64, width=64,
                     num_frames=9, stage1_steps=1, stage2_steps=1, num_videos=2, dtype=torch.float32)
assert res.video.shape == (2, 3, 9, 64, 64)
# audio: a tiny AudioVideo DiT (joint), then a tiny AudioOnly one (separate), each to a WAV
import dataclasses, wave
from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import AudioVAEConfig, init_audio_decoder
from mlx_video_tpu_torch.models.ltx.audio_vae.vocoder import VocoderConfig, init_vocoder
av_cfg = dataclasses.replace(tiny_test_config(LTXModelType.AudioVideo, rope_type=LTXRopeType.SPLIT),
                             audio_in_channels=128, audio_out_channels=128)
ao_cfg = dataclasses.replace(av_cfg, model_type=LTXModelType.AudioOnly)
audio_parts = dict(audio_decoder=init_audio_decoder(g, AudioVAEConfig(ch=8), device="cpu", dtype=torch.float32),
                   audio_decoder_config=AudioVAEConfig(ch=8), vocoder_config=VocoderConfig(upsample_initial_channel=32),
                   vocoder=init_vocoder(g, VocoderConfig(upsample_initial_channel=32), device="cpu",
                                        dtype=torch.float32))
joint = dataclasses.replace(models, transformer=init_ltx_params(av_cfg, g, device="cpu", dtype=torch.float32),
                            transformer_config=av_cfg, **audio_parts)
separate = dataclasses.replace(models, audio_transformer=init_ltx_params(ao_cfg, g, device="cpu", dtype=torch.float32),
                               audio_transformer_config=ao_cfg, **audio_parts)
with tempfile.TemporaryDirectory() as tmp:
    for mode, bundle in (("joint", joint), ("separate", separate)):
        res = generate_video(bundle, TextConditioning(torch.zeros(1, 4, 48), audio_embeddings=torch.ones(1, 4, 48)),
                             height=64, width=64, num_frames=9, stage1_steps=1, stage2_steps=1, audio_steps=1,
                             audio=True, audio_mode=mode, output_path=f"{tmp}/{mode}.mp4", video_encoder="cv2",
                             dtype=torch.float32)
        with wave.open(f"{tmp}/{mode}.wav", "rb") as wf:
            assert (wf.getnchannels(), wf.getnframes()) == (2, 240 * (4 * 9 - 3))
        assert res.audio_latents.shape == (1, 8, 9, 16) and res.video_path.stat().st_size > 0
# the q4 path: quantize in place, write and read a native file, generate
import tempfile
from mlx_video_tpu_torch.io.weights import load_dit_params, save_dit_params
from mlx_video_tpu_torch.ops.quant import quantize_dit_params
quantize_dit_params(models.transformer, group_size=64, bits=4)
with tempfile.TemporaryDirectory() as tmp:
    save_dit_params(f"{tmp}/q4.safetensors", models.transformer)
    models.transformer = load_dit_params(f"{tmp}/q4.safetensors", cfg, dtype=torch.float32, device="cpu")
assert models.transformer.blocks[0].ff.proj_in.bits == 4
# convert: the dense tiny DiT as a native source -> a 4-bit file with its report, unified; read through the prefetcher
import json
from mlx_video_tpu_torch.convert import main as convert_main
from mlx_video_tpu_torch.io.prefetch import FilePrefetcher
with tempfile.TemporaryDirectory() as tmp:
    save_dit_params(f"{tmp}/src.safetensors", init_ltx_params(cfg, g, device="cpu", dtype=torch.float32))
    with open(f"{tmp}/cfg.json", "w") as f:
        json.dump(cfg.to_dict(), f)
    convert_main(["-i", f"{tmp}/src.safetensors", "-o", f"{tmp}/out/ltx-2-19b-distilled.safetensors", "--model-type",
                  "video", "--config", f"{tmp}/cfg.json", "--quantize", "--unified", "--report", "--device", "cpu"])
    with FilePrefetcher(2) as fetcher:
        assert fetcher.is_native and fetcher.get(f"{tmp}/out/quantization.json").startswith(b"{")
res = generate_video(models, TextConditioning(torch.zeros(1, 4, cfg.caption_channels)), height=64,
                     width=64, num_frames=9, stage1_steps=1, stage2_steps=1, dtype=torch.float32)
assert res.video.shape == (1, 3, 9, 64, 64)
# one LoRA training step over the q4 base, with gradient checkpointing
from mlx_video_tpu_torch.trainer.config import TrainingConfig
from mlx_video_tpu_torch.trainer.datasets import DummyDataset
from mlx_video_tpu_torch.trainer.trainer import Trainer
with tempfile.TemporaryDirectory() as tmp:
    data = DummyDataset(width=64, height=64, num_frames=9, dataset_length=1, latent_dim=cfg.in_channels,
                        prompt_embed_dim=cfg.caption_channels, prompt_sequence_length=4)
    trainer = Trainer(TrainingConfig(training_mode="lora", steps=1, output_dir=tmp, handle_preemption=False,
                                     enable_gradient_checkpointing=True, mixed_precision_mode="fp32"),
                      model_config=cfg, params=models.transformer, dataset=data)
    assert np.isfinite(trainer.train())
# W8A8 execution, a tiny text encoder in W8A8 on token ids, and K6's plain version
from mlx_video_tpu_torch.loading import quantize_models
from mlx_video_tpu_torch.models.gemma3 import Gemma3TextConfig, init_gemma3_params
from mlx_video_tpu_torch.models.ltx.text_encoder import encode_tokens, init_text_encoder_params
from mlx_video_tpu_torch.ops.flash_attention import flash_attention_int8
from mlx_video_tpu_torch.ops.int8 import quantize_text_encoder_w8a8
models.transformer = init_ltx_params(cfg, g, device="cpu", dtype=torch.float32)
quantize_models(models, None, w8a8=True)
with torch.no_grad():
    res = generate_video(models, TextConditioning(torch.zeros(1, 4, cfg.caption_channels)), height=64,
                         width=64, num_frames=9, stage1_steps=1, stage2_steps=1, dtype=torch.float32)
assert res.video.shape == (1, 3, 9, 64, 64)
tcfg = Gemma3TextConfig(vocab_size=64, hidden_size=cfg.caption_channels, intermediate_size=96, num_hidden_layers=2,
                        num_attention_heads=2, num_key_value_heads=1, head_dim=16, sliding_window=4,
                        sliding_window_pattern=2)
te = init_text_encoder_params(tcfg, g, tcfg.hidden_size, device="cpu", dtype=torch.float32,
                              language_model=init_gemma3_params(tcfg, g, device="cpu", dtype=torch.float32))
quantize_text_encoder_w8a8(te)
with torch.no_grad():
    video, audio = encode_tokens(te, tcfg, torch.randint(0, 64, (1, 8), generator=g), torch.ones(1, 8, dtype=torch.long))
assert video.shape == audio.shape == (1, 8, cfg.caption_channels) and bool(torch.isfinite(video).all())
q = torch.randn(1, 70, 2, 64, generator=g)
assert flash_attention_int8(q, q, q).shape == q.shape
loaded = [m for m in sys.modules if m in ("jax", "ml_dtypes", "flax") or m.split(".")[0] == "mlx_video_tpu"]
assert not [m for m in loaded if sys.modules[m] is not None], loaded
print("NO_JAX_OK")
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
