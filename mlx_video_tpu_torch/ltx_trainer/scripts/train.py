#!/usr/bin/env python3
"""Training entry (reference: ltx_trainer/scripts/train.py)."""

from mlx_video_tpu_torch.cli.train import main

if __name__ == "__main__":
    main()
