#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mlx_video_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
1. device: needs CUDA; prints the card's name and power limit (nvidia-smi).
2. build: compiles the CUDA kernels from mlx_video_tpu_torch/csrc with nvcc,
   one process per source.
3. K1 vs plain: the flash-attention kernel against its plain fp32 version in
   bf16 at B=1, H=32, D=128, S = 320 and 1280 (the distilled path's shapes),
   1000 (ragged) and 5184 with lse, plus one D=64 case: max |d o| <= 2e-2
   (one bf16 ulp at |o| ~ 2-4) and max |d lse| <= 1e-3; median times of both
   from CUDA events after warm-up.
4. K2 vs plain: the dequantizing matmul against its plain version (the same
   bf16 weights, dequantized, then a matmul) at the q4 path's shapes, M in
   (128, 320, 1280) x (K, N) in ((4096, 4096), (4096, 16384), (16384,
   4096)), bits 4, group 64, plus bits 8 / group 128, bits 2 / group 32,
   bits 4 / group 16, a ragged M = 300 and bf16 and fp16 scales: max |d y|
   <= 1e-2 max |y| and relative L2 <= 1e-3 (only the summation order and
   the bf16 rounding of y differ). The control, at every case with fp32
   scales: the plain version on bf16-rounded scales and biases (the Pallas
   kernel's rounding) must fail the L2 bar. Median times of the kernel, the
   plain version and dense cuBLAS on the dequantized bf16 weight, each
   launch after an L2 flush.
5. small slices vs reference: a 2-layer DiT denoise (2 steps at 320 tokens),
   upsampler and decoder at narrow width, bf16 on the card against fp32 on
   the CPU (plain attention, plain dequantizing matmul) with the same
   weights and inputs, dense and with the DiT quantized to 4 bits: per-frame
   PSNR >= 35 dB, the repo's pipeline gate.
6. full-width dense slice: generate_video, distilled, 512x512x33, on
   synthetic bf16 weights of the 19B video DiT geometry (48 layers, 32x128
   heads), the default VAE decoder and the 1024-channel upsampler, all drawn
   on the card from a seeded generator. Checks a finite (1, 3, 33, 512, 512)
   video and 48 x (8 + 3) = 528 K1 launches.
7. full-width q4 slice: the same DiT quantized in place on the card
   (quantize_dit_params, 4 bits, group 64, core scope: 10 linears a block),
   then the same run: 528 K1 and 10 x 48 x 11 = 5280 K2 launches.
8. loaders and CLI: the q4 DiT written as an MLX pre-quantized snapshot
   (ltx-2-19b-distilled-4bit-mlx.safetensors: sanitized keys, uint32
   words under .weight, .scales, .biases), with the decoder, the upsampler
   and an embeddings file, in a temporary directory; load_model_bundle must
   give tensors equal to the in-memory ones, and the CLI's main (--device
   cuda) must run from that directory with 528 K1 and 5280 K2 launches and
   write its output. The directory is removed at the end.
Phases 6-8 print phase times and peak device memory. Last: the kernel
summary line and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SHAPES_K2 = [(m, k, n) for m in (128, 320, 1280) for k, n in ((4096, 4096), (4096, 16384), (16384, 4096))]


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(fn, reps: int = 20, warmup: int = 3, before=None) -> float:
    """Median CUDA-event time of ``fn``; ``before`` runs ahead of each timed
    launch, outside the events (an L2 flush)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def psnr(a, b, peak: float) -> float:
    import numpy as np

    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * float(np.log10(peak * peak / mse))


def kernel_vs_plain(fa) -> dict:
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    rows, max_o, max_lse = {}, 0.0, 0.0
    print("kernel vs plain (bf16, B=1, H=32):")
    for s, d, with_lse in [(320, 128, False), (1280, 128, False), (1000, 128, True),
                           (5184, 128, True), (1280, 64, True)]:
        q, k, v = (torch.randn(1, s, 32, d, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
        scale = d**-0.5
        out = fa.flash_attention(q, k, v, scale=scale, return_lse=with_lse)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q, k, v, scale, return_lse=with_lse)
        if with_lse:
            (out, lse), (ref, ref_lse) = out, ref
            err_lse = (lse - ref_lse).abs().max().item()
            max_lse = max(max_lse, err_lse)
        err_o = (out.float() - ref.float()).abs().max().item()
        max_o = max(max_o, err_o)
        ms = median_ms(lambda: fa.flash_attention(q, k, v, scale=scale, return_lse=with_lse))
        plain_ms = median_ms(lambda: fa.flash_attention_reference(q, k, v, scale, return_lse=with_lse))
        lse_txt = f" max|d lse| {err_lse:.3e}" if with_lse else ""
        print(f"  S={s} D={d} lse={with_lse}: max|d o| {err_o:.3e}{lse_txt}  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms", flush=True)
        if not err_o <= 2e-2 or (with_lse and not err_lse <= 1e-3):
            fail(f"kernel disagrees with the plain version at S={s} D={d}")
        rows[(s, d)] = (ms, plain_ms)
        del q, k, v, out, ref
    return {"rows": rows, "max_abs_err": max(max_o, max_lse)}


def quant_kernel_vs_plain(qmm) -> dict:
    import torch

    from mlx_video_tpu_torch.ops.quant import dequantize_affine, quantize_affine

    g = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    rows, max_err, max_l2, min_control = {}, 0.0, 0.0, float("inf")
    cases = [(m, k, n, 4, 64, torch.float32) for m, k, n in SHAPES_K2] + [
        (320, 4096, 4096, 8, 128, torch.float32), (320, 4096, 4096, 2, 32, torch.float32),
        (320, 4096, 4096, 4, 16, torch.float32), (300, 4096, 16384, 4, 64, torch.float32),
        (320, 4096, 4096, 4, 64, torch.bfloat16), (320, 4096, 4096, 4, 64, torch.float16),
    ]
    print("K2 vs plain (bf16 x; times after an L2 flush):")
    for m, k, n, bits, group, sdt in cases:
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        packed, scales, biases = quantize_affine(torch.randn(n, k, generator=g, device="cuda") * k**-0.5, group, bits)
        scales, biases = scales.to(sdt), biases.to(sdt)
        y = qmm.quant_matmul(x, packed, scales, biases, bits, group)
        torch.cuda.synchronize()
        ref = qmm.quant_matmul_reference(x, packed, scales, biases, bits, group)
        d = y.float() - ref.float()
        err = d.abs().max().item()
        rel_max, rel_l2 = err / ref.float().abs().max().item(), (d.norm() / ref.float().norm()).item()
        max_err, max_l2 = max(max_err, err), max(max_l2, rel_l2)
        line = (f"  M={m} K={k} N={n} bits={bits} group={group} scales={str(sdt)[6:]}: max|d y| {err:.3e} "
                f"({rel_max:.2e} of max|y|), rel L2 {rel_l2:.2e}")
        control = float("inf")
        if sdt == torch.float32:
            rounded = qmm.quant_matmul_reference(x, packed, scales.bfloat16(), biases.bfloat16(), bits, group)
            control = ((rounded.float() - ref.float()).norm() / ref.float().norm()).item()
            min_control = min(min_control, control)
            line += f", control rel L2 {control:.2e}"
            del rounded
        if (m, k, n) in SHAPES_K2 and (bits, sdt) == (4, torch.float32):
            w = dequantize_affine(packed, scales, biases, bits=bits, dtype=torch.bfloat16)
            ms = median_ms(lambda: qmm.quant_matmul(x, packed, scales, biases, bits, group), before=flush.zero_)
            plain_ms = median_ms(lambda: qmm.quant_matmul_reference(x, packed, scales, biases, bits, group),
                                 before=flush.zero_)
            dense_ms = median_ms(lambda: x @ w.T, before=flush.zero_)
            rows[(m, k, n)] = (ms, plain_ms)
            line += (f"  kernel {ms:.4f} ms ({2 * m * k * n / ms / 1e9:.1f} TFLOP/s)  plain {plain_ms:.4f} ms  "
                     f"dense cuBLAS {dense_ms:.4f} ms")
            del w
        print(line, flush=True)
        if not (rel_max <= 1e-2 and rel_l2 <= 1e-3 and torch.isfinite(y).all()):
            fail(f"K2 disagrees with the plain version at M={m} K={k} N={n} bits={bits} group={group}")
        if not control > 1e-3:
            fail(f"the control (bf16-rounded scales) passes the K2 bar at M={m} K={k} N={n} bits={bits}")
        del x, packed, scales, biases, y, ref, d
    del flush
    print(f"  K2 worst rel L2 {max_l2:.3e}; the control's least {min_control:.3e}; bar 1e-3", flush=True)
    return {"rows": rows, "max_abs_err": max_err}


def to_card(dit, device, dtype):
    """A copy of the DiT on ``device`` with its parameters in ``dtype``; the
    quantized words, scales and biases (buffers) keep their dtypes."""
    d = copy.deepcopy(dit).to(device)
    for p in d.parameters():
        p.data = p.data.to(dtype)
    return d


def small_slice_check(quantized: bool) -> None:
    import numpy as np
    import torch

    from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType
    from mlx_video_tpu_torch.models.ltx.model import init_ltx_params
    from mlx_video_tpu_torch.models.ltx.upsampler import init_latent_upsampler, upsample_latents
    from mlx_video_tpu_torch.models.ltx.video_vae.decoder import (
        DecoderConfig, init_video_decoder, video_decoder_apply,
    )
    from mlx_video_tpu_torch.ops.quant import quantize_dit_params
    from mlx_video_tpu_torch.pipelines import denoise as dn
    from mlx_video_tpu_torch.pipelines.generate import create_position_grid, STAGE_1_SIGMAS, subsample_sigmas

    cfg = LTXModelConfig(
        model_type=LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT, double_precision_rope=True,
        num_attention_heads=4, attention_head_dim=128, num_layers=2,
        cross_attention_dim=512, caption_channels=256,
    )
    g = torch.Generator().manual_seed(5)
    dit = init_ltx_params(cfg, g, device="cpu", dtype=torch.float32)
    if quantized:
        quantize_dit_params(dit, group_size=64, bits=4)  # the same words on both sides
    dec_cfg = DecoderConfig(base_channels=64, num_layers_per_block=1)
    dec = init_video_decoder(g, dec_cfg, device="cpu")
    dec.latents_mean.normal_(generator=g).mul_(0.1)
    dec.latents_std.uniform_(0.7, 1.3, generator=g)
    ups = init_latent_upsampler(g, 128, 64, 1, device="cpu")
    lat = torch.randn(1, 128, 5, 8, 8, generator=g)
    ctx = torch.randn(1, 16, 256, generator=g)
    pos = torch.from_numpy(create_position_grid(1, 5, 8, 8))
    sigmas = subsample_sigmas(STAGE_1_SIGMAS, 2, "farthest")

    def run(device, dtype):
        to = dict(device=device, dtype=dtype)
        d = to_card(dit, device, dtype)
        u, m = (copy.deepcopy(x).to(**to) for x in (ups, dec))
        m.latents_mean, m.latents_std = dec.latents_mean.to(device), dec.latents_std.to(device)
        x = dn.denoise(d, cfg, lat.to(**to), pos.to(device), ctx.to(**to), sigmas)
        up = upsample_latents(u, x, m.latents_mean, m.latents_std)
        rgb = video_decoder_apply(m, dec_cfg, up)
        return [t.float().cpu().numpy() for t in (x, up, rgb)]

    ref = run("cpu", torch.float32)
    got = run("cuda", torch.bfloat16)
    kind = "q4 DiT" if quantized else "dense DiT"
    for name, r, o in zip(("stage-1 latents", "upsampled latents", "decoded rgb"), ref, got):
        peak = 2.0 if name == "decoded rgb" else float(np.abs(r).max())
        worst = min(psnr(o[:, :, i], r[:, :, i], peak) for i in range(r.shape[2]))
        print(f"  {kind}, {name}: min per-frame PSNR {worst:.2f} dB (card bf16 vs CPU fp32)", flush=True)
        if not np.isfinite(o).all() or worst < 35.0:
            fail(f"small slice ({kind}) {name} PSNR {worst:.2f} dB < 35 dB")


def full_width_models():
    """The 19B video DiT geometry, the default decoder and the 1024-channel
    upsampler, in bf16, drawn on the card from a seeded generator."""
    import torch

    from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType
    from mlx_video_tpu_torch.models.ltx.model import init_ltx_params
    from mlx_video_tpu_torch.models.ltx.upsampler import init_latent_upsampler
    from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, init_video_decoder
    from mlx_video_tpu_torch.pipelines.generate import ModelBundle, TextConditioning

    config = LTXModelConfig(model_type=LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT,
                            double_precision_rope=True)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    # the decoder's own seed: the loader's init (seed 0) must not match it, so
    # a tensor the loader missed shows in the comparison of phase 8
    decoder = init_video_decoder(torch.Generator(device=dev).manual_seed(2), DecoderConfig(), device=dev, dtype=bf16)
    decoder.latents_mean.normal_(generator=g).mul_(0.1)
    decoder.latents_std.uniform_(0.7, 1.3, generator=g)
    models = ModelBundle(
        transformer=init_ltx_params(config, g, device=dev, dtype=bf16),
        transformer_config=config,
        vae_decoder=decoder,
        vae_decoder_config=DecoderConfig(),
        upsampler=init_latent_upsampler(g, 128, 1024, 4, device=dev, dtype=bf16),
    )
    text = TextConditioning(torch.randn(1, 128, config.caption_channels, generator=g, device=dev).to(bf16))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in models.transformer.parameters())
    print(f"  synthetic weights drawn on the card in {time.perf_counter() - t0:.2f} s "
          f"(DiT {n_params / 1e9:.2f} B params)", flush=True)
    return models, text


def check_video(video, latents, k1: int, k2: int, want_k2: int) -> None:
    import numpy as np

    if video is None or video.shape != (1, 3, 33, 512, 512):
        fail(f"video shape {None if video is None else video.shape}, want (1, 3, 33, 512, 512)")
    if not np.isfinite(video).all() or not np.isfinite(latents).all():
        fail("non-finite video or latents")
    print(f"  video {video.shape} finite; range [{video.min():.4f}, {video.max():.4f}], "
          f"std {video.std():.4f}", flush=True)
    check_launches(k1, k2, want_k2)


def check_launches(k1: int, k2: int, want_k2: int) -> None:
    if k1 != 48 * (8 + 3):
        fail(f"{k1} K1 (flash attention) launches in the run, want {48 * (8 + 3)}")
    if k2 != want_k2:
        fail(f"{k2} K2 (dequantizing matmul) launches in the run, want {want_k2}")


def drive_slice(models, text, fa, qmm, want_k2: int) -> dict:
    """generate_video at 512x512x33, 8 + 3 steps, counts set to 0 just before."""
    import torch

    from mlx_video_tpu_torch.pipelines.generate import generate_video

    torch.cuda.reset_peak_memory_stats()
    fa.launch_count = qmm.launch_count = 0
    t0 = time.perf_counter()
    res = generate_video(models, text, height=512, width=512, num_frames=33, stage1_steps=8,
                         stage2_steps=3, tiling="auto", output_path=None,
                         generator=torch.Generator(device="cuda").manual_seed(1))
    wall = time.perf_counter() - t0
    k1, k2 = fa.launch_count, qmm.launch_count
    peak = torch.cuda.max_memory_allocated()
    for name, sec in res.phase_seconds.items():
        print(f"  phase {name}: {sec:.4f} s", flush=True)
    print(f"  generate_video wall {wall:.4f} s; peak device memory {peak / 2**30:.3f} GiB; "
          f"launches K1 {k1}, K2 {k2}", flush=True)
    check_video(res.video, res.latents, k1, k2, want_k2)
    return {"k1": k1, "k2": k2}


def quantize_full_width(models) -> None:
    import torch

    from mlx_video_tpu_torch.ops.linear import QuantLinear
    from mlx_video_tpu_torch.ops.quant import quantize_dit_params

    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    quantize_dit_params(models.transformer, group_size=64, bits=4, scope="core")  # in place
    torch.cuda.synchronize()
    n = sum(isinstance(m, QuantLinear) for m in models.transformer.modules())
    print(f"  quantized in place in {time.perf_counter() - t0:.2f} s: {n} QuantLinears; device memory "
          f"{before / 2**30:.3f} -> {torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    if n != 10 * 48:
        fail(f"{n} quantized linears, want {10 * 48}")


def mlx_key(name: str) -> str:
    """Port DiT state name -> sanitized MLX key (packed words under .weight):
    the inverse of io/weights.py's mapping, for writing a snapshot."""
    key = "transformer_blocks." + name[len("blocks."):] if name.startswith("blocks.") else name[len("video."):]
    return key[: -len("quant_weight")] + "weight" if key.endswith(".quant_weight") else key


def decoder_key(name: str) -> str:
    """Port decoder state name -> checkpoint key (the inverse of
    io/vae_weights.py's remap, with the CausalConv .conv nesting)."""
    if name == "latents_mean":
        return "per_channel_statistics.mean-of-means"
    if name == "latents_std":
        return "per_channel_statistics.std-of-means"
    parts = name.split(".")
    if parts[0] == "up_blocks":
        i, rest = int(parts[1]), parts[2:]
        if rest[0] == "res_blocks":
            rest = ["resnets"] + rest[1:]
        if i == 0:
            parts = ["mid_block"] + rest
        elif i % 2 == 0:
            parts = ["up_blocks", str(i // 2 - 1)] + rest
        else:
            parts = ["up_blocks", str(i // 2), "upsamplers", "0"] + rest
    if len(parts) >= 2 and parts[-2] in ("conv1", "conv2", "conv_in", "conv_out"):
        parts = parts[:-1] + ["conv", parts[-1]]
    key = ".".join(parts)
    return key if key.startswith("per_channel") else "decoder." + key


def snapshot_and_cli(models, text, fa, qmm) -> dict:
    """Write the q4 model as an MLX pre-quantized snapshot, load it back, and
    run the CLI on it."""
    import torch

    from mlx_video_tpu_torch import loading
    from mlx_video_tpu_torch.cli import generate as cli
    from mlx_video_tpu_torch.io.safetensors import save_safetensors

    files = {
        "ltx-2-19b-distilled-4bit-mlx.safetensors": {
            mlx_key(k): v.view(torch.uint32) if k.endswith(".quant_weight") else v
            for k, v in models.transformer.state_dict().items()
        },
        "vae/diffusion_pytorch_model.safetensors": {
            decoder_key(k): v for k, v in models.vae_decoder.state_dict().items()
        },
        loading.UPSAMPLER_FILE: dict(models.upsampler.state_dict()),
    }
    need = sum(t.numel() * t.element_size() for f in files.values() for t in f.values())
    roots = [Path(tempfile.gettempdir()), Path(__file__).resolve().parent]
    free = {root: shutil.disk_usage(root).free for root in roots}
    print("  free disk: " + ", ".join(f"{r} {b / 2**30:.1f} GiB" for r, b in free.items())
          + f"; the snapshot needs {need / 2**30:.2f} GiB", flush=True)
    root = max(roots, key=free.get)
    if free[root] < 1.2 * need + 2**30:
        fail(f"no directory with {need / 2**30:.2f} GiB free for the snapshot")
    tmp = Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=root))
    try:
        snap = tmp / "ltx2-distilled-4bit-mlx"
        (snap / "vae").mkdir(parents=True)
        t0 = time.perf_counter()
        for name, tensors in files.items():
            save_safetensors(snap / name, tensors)
        embeddings = tmp / "embeddings.safetensors"
        save_safetensors(embeddings, {"video_prompt_embeds": text.video_embeddings[0]})
        print(f"  wrote the snapshot to {root} in {time.perf_counter() - t0:.2f} s", flush=True)
        del files

        t0 = time.perf_counter()
        bundle = loading.load_model_bundle(snap, bits_hint=loading.bits_hint_for(str(snap)), device="cuda")
        torch.cuda.synchronize()
        print(f"  load_model_bundle: {time.perf_counter() - t0:.2f} s", flush=True)
        n = 0
        for part in ("transformer", "vae_decoder", "upsampler"):
            want, got = getattr(models, part).state_dict(), getattr(bundle, part).state_dict()
            if set(want) != set(got):
                fail(f"loaded {part} has other tensors: {sorted(set(want) ^ set(got))[:10]}")
            bad = [k for k in want if want[k].dtype != got[k].dtype or not torch.equal(want[k], got[k])]
            if bad:
                fail(f"loaded {part} differs from the in-memory one at {bad[:10]}")
            n += len(want)
        print(f"  the loaded snapshot equals the in-memory model: {n} tensors, torch.equal", flush=True)
        del bundle
        torch.cuda.empty_cache()

        has_ffmpeg, has_cv2 = shutil.which("ffmpeg") is not None, importlib.util.find_spec("cv2") is not None
        output, report = tmp / "out.mp4", tmp / "phases.json"
        argv = ["--prompt", "synthetic embeddings", "--checkpoint-path", str(snap), "--embeddings", str(embeddings),
                "--height", "512", "--width", "512", "--num-frames", "33", "--seed", "1",
                "--output-path", str(output), "--profile-json-path", str(report), "--device", "cuda"]
        print(f"  video writers on this machine: ffmpeg {has_ffmpeg}, cv2 {has_cv2}", flush=True)
        if not (has_ffmpeg or has_cv2):
            argv.append("--latents-only")
            print("  neither ffmpeg nor cv2 is here: the CLI runs with --latents-only (the mp4 write is "
                  "tested on the CPU)", flush=True)
        torch.cuda.reset_peak_memory_stats()
        fa.launch_count = qmm.launch_count = 0
        t0 = time.perf_counter()
        cli.main(argv)
        wall = time.perf_counter() - t0
        k1, k2 = fa.launch_count, qmm.launch_count
        phases = json.loads(report.read_text())["phases"]
        for name, sec in phases.items():
            print(f"  CLI phase {name}: {sec:.4f} s", flush=True)
        print(f"  CLI main wall {wall:.4f} s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches K1 {k1}, K2 {k2}", flush=True)
        if "--latents-only" not in argv:
            if not output.is_file() or output.stat().st_size == 0:
                fail(f"the CLI wrote no video at {output}")
            print(f"  CLI wrote {output.name}: {output.stat().st_size} bytes", flush=True)
        check_launches(k1, k2, 10 * 48 * (8 + 3))
        return {"k1": k1, "k2": k2}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from mlx_video_tpu_torch.ops import _build
    from mlx_video_tpu_torch.ops import flash_attention as fa
    from mlx_video_tpu_torch.ops import quant_matmul as qmm

    # fp32 references stay fp32 on the card (the bf16 path is unaffected)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({_build.library_path().name})", flush=True)
    for line in _build.build_log_path().read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    k1 = kernel_vs_plain(fa)
    k2 = quant_kernel_vs_plain(qmm)
    print("small slices, card vs CPU reference:", flush=True)
    small_slice_check(quantized=False)
    small_slice_check(quantized=True)
    models, text = full_width_models()
    print("full-width distilled slice (512x512x33, 19B video DiT geometry, bf16):", flush=True)
    drive_slice(models, text, fa, qmm, want_k2=0)
    print("full-width q4 slice (the same DiT, 4 bits, group 64, core scope):", flush=True)
    quantize_full_width(models)
    q4 = drive_slice(models, text, fa, qmm, want_k2=10 * 48 * (8 + 3))
    print("MLX pre-quantized snapshot -> load_model_bundle -> CLI main:", flush=True)
    snapshot_and_cli(models, text, fa, qmm)

    k1_ms, k1_plain_ms = k1["rows"][(1280, 128)]
    k2_ms, k2_plain_ms = k2["rows"][(1280, 4096, 16384)]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "mlx_video_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mlx_video_tpu/ops/flash_attention.py:102",
        "launches": q4["k1"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1_ms,
        "plain_ms": k1_plain_ms,
    }, {
        "name": "quant_matmul",
        "route": "cuda",
        "source": "mlx_video_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "mlx_video_tpu/ops/quant_matmul.py:87",
        "launches": q4["k2"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
