#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mlx_video_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
1. device: needs CUDA; prints the card's name and power limit (nvidia-smi).
2. build: compiles the CUDA kernels from mlx_video_tpu_torch/csrc with nvcc.
3. kernel vs plain: the flash-attention kernel against its plain fp32
   version in bf16 at B=1, H=32, D=128, S = 320 and 1280 (the distilled
   path's shapes), 1000 (ragged) and 5184 with lse, plus one D=64 case:
   max |d o| <= 2e-2 (one bf16 ulp at |o| ~ 2-4) and max |d lse| <= 1e-3;
   median times of both from CUDA events after warm-up.
4. small slice vs reference: a 2-layer DiT denoise (2 steps at 320 tokens),
   upsampler and decoder at narrow width, bf16 on the card against fp32 on
   the CPU (plain attention) with the same weights and inputs: per-frame
   PSNR >= 35 dB, the repo's pipeline gate.
5. full-width slice: generate_video, distilled, 512x512x33, on synthetic
   bf16 weights of the 19B video DiT geometry (48 layers, 32x128 heads),
   the default VAE decoder and the 1024-channel upsampler, all drawn on the
   card from a seeded generator. Checks a finite (1, 3, 33, 512, 512) video
   and exactly 48 x (8 + 3) = 528 kernel launches; prints phase times and
   peak device memory.
6. prints the kernel summary line and, last, {"ok": true, "device": ...}.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def small_slice_check() -> None:
    import numpy as np
    import torch

    from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType
    from mlx_video_tpu_torch.models.ltx.model import init_ltx_params
    from mlx_video_tpu_torch.models.ltx.upsampler import init_latent_upsampler, upsample_latents
    from mlx_video_tpu_torch.models.ltx.video_vae.decoder import (
        DecoderConfig, init_video_decoder, video_decoder_apply,
    )
    from mlx_video_tpu_torch.pipelines import denoise as dn
    from mlx_video_tpu_torch.pipelines.generate import create_position_grid, STAGE_1_SIGMAS, subsample_sigmas

    cfg = LTXModelConfig(
        model_type=LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT, double_precision_rope=True,
        num_attention_heads=4, attention_head_dim=128, num_layers=2,
        cross_attention_dim=512, caption_channels=256,
    )
    g = torch.Generator().manual_seed(5)
    dit = init_ltx_params(cfg, g, device="cpu", dtype=torch.float32)
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
        d, u, m = (copy.deepcopy(x).to(**to) for x in (dit, ups, dec))
        m.latents_mean, m.latents_std = dec.latents_mean.to(device), dec.latents_std.to(device)
        x = dn.denoise(d, cfg, lat.to(**to), pos.to(device), ctx.to(**to), sigmas)
        up = upsample_latents(u, x, m.latents_mean, m.latents_std)
        rgb = video_decoder_apply(m, dec_cfg, up)
        return [t.float().cpu().numpy() for t in (x, up, rgb)]

    ref = run("cpu", torch.float32)
    got = run("cuda", torch.bfloat16)
    for name, r, o in zip(("stage-1 latents", "upsampled latents", "decoded rgb"), ref, got):
        peak = 2.0 if name == "decoded rgb" else float(np.abs(r).max())
        worst = min(psnr(o[:, :, i], r[:, :, i], peak) for i in range(r.shape[2]))
        print(f"  {name}: min per-frame PSNR {worst:.2f} dB (card bf16 vs CPU fp32)", flush=True)
        if not np.isfinite(o).all() or worst < 35.0:
            fail(f"small slice {name} PSNR {worst:.2f} dB < 35 dB")


def full_width_slice(fa) -> dict:
    import numpy as np
    import torch

    from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType
    from mlx_video_tpu_torch.models.ltx.model import init_ltx_params
    from mlx_video_tpu_torch.models.ltx.upsampler import init_latent_upsampler
    from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, init_video_decoder
    from mlx_video_tpu_torch.pipelines.generate import ModelBundle, TextConditioning, generate_video

    config = LTXModelConfig(model_type=LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT,
                            double_precision_rope=True)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    decoder = init_video_decoder(g, DecoderConfig(), device=dev, dtype=bf16)
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

    torch.cuda.reset_peak_memory_stats()
    fa.launch_count = 0
    t0 = time.perf_counter()
    res = generate_video(models, text, height=512, width=512, num_frames=33, stage1_steps=8,
                         stage2_steps=3, tiling="auto", output_path=None,
                         generator=torch.Generator(device=dev).manual_seed(1))
    wall = time.perf_counter() - t0
    launches = fa.launch_count
    peak = torch.cuda.max_memory_allocated()
    for name, sec in res.phase_seconds.items():
        print(f"  phase {name}: {sec:.4f} s", flush=True)
    print(f"  generate_video wall {wall:.4f} s; peak device memory {peak / 2**30:.3f} GiB; "
          f"flash kernel launches {launches}", flush=True)
    video = res.video
    if video is None or video.shape != (1, 3, 33, 512, 512):
        fail(f"video shape {None if video is None else video.shape}, want (1, 3, 33, 512, 512)")
    if not np.isfinite(video).all() or not np.isfinite(res.latents).all():
        fail("non-finite video or latents")
    print(f"  video {video.shape} finite; range [{video.min():.4f}, {video.max():.4f}], "
          f"std {video.std():.4f}", flush=True)
    if launches != 48 * (8 + 3):
        fail(f"{launches} flash kernel launches in the slice, want {48 * (8 + 3)}")
    return {"launches": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from mlx_video_tpu_torch.ops import _build
    from mlx_video_tpu_torch.ops import flash_attention as fa

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

    kv = kernel_vs_plain(fa)
    print("small slice, card vs CPU reference:", flush=True)
    small_slice_check()
    print("full-width distilled slice (512x512x33, 19B video DiT geometry, bf16):", flush=True)
    full = full_width_slice(fa)

    ms, plain_ms = kv["rows"][(1280, 128)]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "mlx_video_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mlx_video_tpu/ops/flash_attention.py:102",
        "launches": full["launches"],
        "max_abs_err": kv["max_abs_err"],
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
