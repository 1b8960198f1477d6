"""``python -m mlx_video_tpu_torch.precompute``: the port's latent precompute
CLI entry (as ``python -m mlx_video_tpu.cli.precompute``)."""

from mlx_video_tpu_torch.trainer.precompute import build_parser, main  # noqa: F401

if __name__ == "__main__":
    main()
