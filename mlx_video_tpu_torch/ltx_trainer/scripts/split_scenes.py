#!/usr/bin/env python3
"""Split videos at scene cuts (reference: ltx_trainer/scripts/split_scenes.py
uses scenedetect; here a histogram-difference detector via cv2)."""

from __future__ import annotations

import argparse
from pathlib import Path


def detect_scene_cuts(video_path: Path, threshold: float = 0.5, min_scene_len: int = 12):
    """Frame indices where a new scene starts (HSV-histogram distance)."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    cuts = [0]
    prev_hist = None
    idx = 0
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        hsv = cv2.cvtColor(frame, cv2.COLOR_BGR2HSV)
        hist = cv2.calcHist([hsv], [0, 1], None, [32, 32], [0, 180, 0, 256])
        hist = cv2.normalize(hist, hist).flatten()
        if prev_hist is not None:
            dist = 1.0 - float(cv2.compareHist(prev_hist, hist, cv2.HISTCMP_CORREL))
            if dist > threshold and idx - cuts[-1] >= min_scene_len:
                cuts.append(idx)
        prev_hist = hist
        idx += 1
    cap.release()
    return cuts + [idx]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Split videos into scenes")
    parser.add_argument("--videos", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--min-scene-len", type=int, default=12)
    args = parser.parse_args(argv)

    import cv2

    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    for video in sorted(Path(args.videos).glob("*.mp4")):
        cuts = detect_scene_cuts(video, args.threshold, args.min_scene_len)
        cap = cv2.VideoCapture(str(video))
        fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        for si, (start, end) in enumerate(zip(cuts[:-1], cuts[1:])):
            writer = cv2.VideoWriter(
                str(out_dir / f"{video.stem}_scene{si:03d}.mp4"),
                cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h),
            )
            cap.set(cv2.CAP_PROP_POS_FRAMES, start)
            for _ in range(end - start):
                ret, frame = cap.read()
                if not ret:
                    break
                writer.write(frame)
            writer.release()
        cap.release()
        print(f"{video.name}: {len(cuts) - 1} scenes")


if __name__ == "__main__":
    main()
