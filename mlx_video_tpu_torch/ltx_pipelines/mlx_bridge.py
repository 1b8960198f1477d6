"""Reference-name compatibility module (reference: ltx_pipelines/mlx_bridge.py)."""

from mlx_video_tpu_torch.ltx_pipelines.bridge import (  # noqa: F401
    MLXPipelineConfig,
    TPUPipelineConfig,
    normalize_images,
    normalize_loras,
    normalize_video_conditions,
    run_generate,
)
