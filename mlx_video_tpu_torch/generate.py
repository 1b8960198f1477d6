"""``python -m mlx_video_tpu_torch.generate``: the port's CLI entry (as
``python -m mlx_video_tpu.generate``). Re-exports the pipeline API."""

from mlx_video_tpu_torch.cli.generate import build_parser, main  # noqa: F401
from mlx_video_tpu_torch.pipelines.generate import (  # noqa: F401
    GenerateResult,
    ModelBundle,
    TextConditioning,
    generate_video,
)

if __name__ == "__main__":
    main()
