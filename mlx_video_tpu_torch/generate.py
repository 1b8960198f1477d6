"""``python -m mlx_video_tpu_torch.generate``: the port's CLI entry (as
``python -m mlx_video_tpu.generate``). Re-exports the pipeline API, the
names the JAX module re-exports."""

from mlx_video_tpu_torch.cli.generate import build_parser, main  # noqa: F401
from mlx_video_tpu_torch.pipelines.generate import (  # noqa: F401
    GenerateResult,
    ModelBundle,
    PipelineType,
    TextConditioning,
    generate_video,
)
from mlx_video_tpu_torch.pipelines.positions import (  # noqa: F401
    AUDIO_LATENTS_PER_SECOND,
    AUDIO_SAMPLE_RATE,
    compute_audio_frames,
    create_audio_position_grid,
    create_position_grid,
)
from mlx_video_tpu_torch.pipelines.prompts import DEFAULT_NEGATIVE_PROMPT  # noqa: F401
from mlx_video_tpu_torch.pipelines.schedulers import (  # noqa: F401
    STAGE_1_SIGMAS,
    STAGE_2_SIGMAS,
    cfg_delta,
    ltx2_scheduler,
)

if __name__ == "__main__":
    main()
