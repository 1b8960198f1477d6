"""``python -m mlx_video_tpu_torch.cli.precompute``: the latent precompute CLI."""

from mlx_video_tpu_torch.trainer.precompute import main

if __name__ == "__main__":
    main()
