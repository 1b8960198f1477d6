#!/usr/bin/env python3
"""Normalize caption files into 'stem: caption' lines
(reference: ltx_trainer/scripts/process_captions.py)."""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Normalize captions")
    parser.add_argument("--input", required=True, help="json/csv/txt captions")
    parser.add_argument("--output", required=True)
    parser.add_argument("--prefix", default="", help="Text prepended to every caption")
    args = parser.parse_args(argv)

    src = Path(args.input)
    entries = {}
    if src.suffix == ".json":
        data = json.loads(src.read_text())
        entries = data if isinstance(data, dict) else {d["video"]: d["caption"] for d in data}
    else:
        for line in src.read_text().splitlines():
            if ":" in line:
                stem, caption = line.split(":", 1)
                entries[stem.strip()] = caption.strip()
    lines = [f"{Path(k).stem}: {args.prefix}{v}".strip() for k, v in entries.items()]
    Path(args.output).write_text("\n".join(lines))
    print(f"Wrote {len(lines)} captions")


if __name__ == "__main__":
    main()
