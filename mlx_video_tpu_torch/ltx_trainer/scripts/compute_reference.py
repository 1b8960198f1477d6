#!/usr/bin/env python3
"""Compute IC-LoRA reference videos (edge maps)
(reference: ltx_trainer/scripts/compute_reference.py)."""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Compute edge-map references")
    parser.add_argument("--videos", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--fps", type=float, default=24.0)
    args = parser.parse_args(argv)

    from mlx_video_tpu_torch.io.media import load_video
    from mlx_video_tpu_torch.trainer.aux import save_video
    from mlx_video_tpu_torch.trainer.precompute import compute_edge_reference

    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    for video in sorted(Path(args.videos).glob("*.mp4")):
        frames = load_video(video)
        save_video(out / video.name, compute_edge_reference(frames), args.fps)
        print(f"reference: {video.name}")


if __name__ == "__main__":
    main()
