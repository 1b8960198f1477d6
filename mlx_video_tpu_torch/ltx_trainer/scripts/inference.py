#!/usr/bin/env python3
"""Inference entry (reference: ltx_trainer/scripts/inference.py)."""

from mlx_video_tpu_torch.cli.generate import main

if __name__ == "__main__":
    main()
