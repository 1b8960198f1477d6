"""Latent/weight parity instrument: PSNR + stats between two safetensors.

The port's copy of mlx_video_tpu/tools/compare_latents.py (numpy; the files
are read through the port's reader, bf16 widened to fp32): PSNR and the
largest difference per tensor of two files of latents or weights, and with
``--per-frame`` per latent frame.

    python -m mlx_video_tpu_torch.tools.compare_latents A.safetensors B.safetensors --per-frame
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float | None = None) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    if data_range is None:
        data_range = float(max(a.max() - a.min(), 1e-12))
    return 10.0 * np.log10(data_range**2 / mse)


def per_frame_psnr(a: np.ndarray, b: np.ndarray, frame_axis: int = 2) -> np.ndarray:
    """Per-frame PSNR over (B, C, F, H, W) latents/video."""
    frames = a.shape[frame_axis]
    return np.array(
        [
            psnr(np.take(a, i, axis=frame_axis), np.take(b, i, axis=frame_axis))
            for i in range(frames)
        ]
    )


def compare_tensors(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray], file=None):
    file = file or sys.stdout
    common = sorted(set(a) & set(b))
    only_a, only_b = sorted(set(a) - set(b)), sorted(set(b) - set(a))
    if only_a:
        print(f"only in A ({len(only_a)}): {only_a[:10]}", file=file)
    if only_b:
        print(f"only in B ({len(only_b)}): {only_b[:10]}", file=file)
    worst = []
    for key in common:
        ta, tb = np.asarray(a[key], np.float64), np.asarray(b[key], np.float64)
        if ta.shape != tb.shape:
            print(f"{key}: SHAPE MISMATCH {ta.shape} vs {tb.shape}", file=file)
            continue
        p = psnr(ta, tb)
        max_abs = float(np.max(np.abs(ta - tb))) if ta.size else 0.0
        worst.append((p, key, max_abs))
    worst.sort()
    for p, key, max_abs in worst[:20]:
        print(f"{key}: psnr={p:.2f}dB max_abs={max_abs:.5f}", file=file)
    if worst:
        print(
            f"\n{len(common)} tensors; worst psnr={worst[0][0]:.2f}dB "
            f"median={worst[len(worst) // 2][0]:.2f}dB",
            file=file,
        )
    return worst


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Compare two safetensors files (PSNR)")
    parser.add_argument("file_a")
    parser.add_argument("file_b")
    parser.add_argument("--per-frame", action="store_true",
                        help="Also report per-frame PSNR for 'latents' keys")
    args = parser.parse_args(argv)

    from mlx_video_tpu_torch.io.safetensors import SafetensorsReader

    with SafetensorsReader(args.file_a) as ra, SafetensorsReader(args.file_b) as rb:
        a = {k: ra.get(k).float().numpy() for k in ra.keys()}
        b = {k: rb.get(k).float().numpy() for k in rb.keys()}
    compare_tensors(a, b)
    if args.per_frame:
        for key in a:
            if key in b and "latent" in key and a[key].ndim >= 5:
                frames = per_frame_psnr(a[key], b[key])
                print(f"{key} per-frame psnr: min={frames.min():.2f} mean={frames.mean():.2f}")


if __name__ == "__main__":
    main()
