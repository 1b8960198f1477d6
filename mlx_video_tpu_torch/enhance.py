"""``python -m mlx_video_tpu_torch.enhance``: the port's prompt-enhancement
CLI entry (as ``python -m mlx_video_tpu.cli.enhance``)."""

from mlx_video_tpu_torch.cli.enhance import build_parser, main  # noqa: F401

if __name__ == "__main__":
    main()
