#!/usr/bin/env python3
"""Organize a CSV/JSON {video, caption} mapping into the trainer layout
(reference: ltx_trainer/scripts/process_dataset.py)."""

from __future__ import annotations

import argparse
import csv
import json
import shutil
from pathlib import Path


def load_mapping(path: Path):
    if path.suffix == ".json":
        data = json.loads(path.read_text())
        if isinstance(data, dict):
            return list(data.items())
        return [(d["video"], d.get("caption", "")) for d in data]
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return [(r.get("video") or r.get("path"), r.get("caption", "")) for r in rows]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Organize dataset mapping")
    parser.add_argument("--mapping", required=True, help="CSV or JSON of video->caption")
    parser.add_argument("--videos-root", default=".")
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)

    out = Path(args.output)
    (out / "videos").mkdir(parents=True, exist_ok=True)
    lines = []
    for video, caption in load_mapping(Path(args.mapping)):
        src = Path(args.videos_root) / video
        if not src.exists():
            print(f"skip missing {src}")
            continue
        shutil.copy2(src, out / "videos" / src.name)
        lines.append(f"{src.stem}: {caption}")
    (out / "prompts.txt").write_text("\n".join(lines))
    print(f"Wrote {len(lines)} entries to {out}")


if __name__ == "__main__":
    main()
