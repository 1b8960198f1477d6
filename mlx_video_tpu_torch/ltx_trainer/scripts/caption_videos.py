#!/usr/bin/env python3
"""Auto-caption videos (reference: ltx_trainer/scripts/caption_videos.py).
Goes through the port's trainer/aux.py, which refuses captioning by name (it
needs a captioning model fetched from the network)."""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Caption videos")
    parser.add_argument("--videos", required=True)
    parser.add_argument("--output", required=True, help="prompts.txt output path")
    parser.add_argument("--model", default="Salesforce/blip-image-captioning-base")
    args = parser.parse_args(argv)

    from mlx_video_tpu_torch.trainer.aux import caption_video

    lines = []
    for video in sorted(Path(args.videos).glob("*.mp4")):
        caption = caption_video(video, args.model)
        lines.append(f"{video.stem}: {caption}")
        print(lines[-1])
    Path(args.output).write_text("\n".join(lines))


if __name__ == "__main__":
    main()
