"""Model configuration: the JAX package's framework-free dataclasses, re-exported."""

from mlx_video_tpu.config import (  # noqa: F401
    LTXModelConfig,
    LTXModelType,
    LTXRopeType,
    tiny_test_config,
)
