"""``python -m mlx_video_tpu_torch.serve``: the port's resident generation
server entry (as ``python -m mlx_video_tpu.cli.serve``)."""

from mlx_video_tpu_torch.cli.serve import GenerationService, build_parser, main, serve  # noqa: F401

if __name__ == "__main__":
    main()
