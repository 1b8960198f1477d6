"""``python -m mlx_video_tpu_torch.train``: the port's training CLI entry (as
``python -m mlx_video_tpu.cli.train``)."""

from mlx_video_tpu_torch.cli.train import build_parser, main  # noqa: F401

if __name__ == "__main__":
    main()
