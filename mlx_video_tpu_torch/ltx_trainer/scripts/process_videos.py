#!/usr/bin/env python3
"""Normalize raw clips to bucket resolutions / frame counts
(reference: ltx_trainer/scripts/process_videos.py)."""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Normalize videos to buckets")
    parser.add_argument("--videos", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--resolution-buckets", required=True, help="WxHxF;...")
    parser.add_argument("--fps", type=float, default=24.0)
    args = parser.parse_args(argv)

    from mlx_video_tpu_torch.io.media import load_video
    from mlx_video_tpu_torch.trainer.aux import save_video
    from mlx_video_tpu_torch.trainer.precompute import fit_to_bucket, parse_buckets, select_bucket

    buckets = parse_buckets(args.resolution_buckets)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    for video in sorted(Path(args.videos).glob("*.mp4")):
        frames = load_video(video)
        bucket = select_bucket(frames, buckets)
        frames = fit_to_bucket(frames, bucket)
        save_video(out_dir / video.name, frames, args.fps)
        print(f"{video.name}: -> {bucket[0]}x{bucket[1]}x{bucket[2]}")


if __name__ == "__main__":
    main()
