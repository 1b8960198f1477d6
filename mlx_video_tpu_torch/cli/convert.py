"""``python -m mlx_video_tpu_torch.cli.convert``: the checkpoint conversion CLI
(convert.py)."""

from mlx_video_tpu_torch.convert import main

if __name__ == "__main__":
    main()
