"""Shim onto the port's trainer strategies (reference:
ltx_trainer/training_strategies/__init__.py)."""

from mlx_video_tpu_torch.trainer.strategies import (  # noqa: F401
    ModelInputs,
    StrategyBatch,
    compute_loss,
    make_inputs,
    prepare_text_to_video,
    prepare_video_to_video,
)

from mlx_video_tpu_torch.ltx_trainer.training_strategies.base_strategy import TrainingStrategy  # noqa: F401
from mlx_video_tpu_torch.ltx_trainer.training_strategies.text_to_video import TextToVideoStrategy  # noqa: F401
from mlx_video_tpu_torch.ltx_trainer.training_strategies.video_to_video import VideoToVideoStrategy  # noqa: F401


def get_training_strategy(cfg) -> TrainingStrategy:
    """Strategy factory (reference: training_strategies/__init__.py:8)."""
    name = getattr(cfg, "strategy", cfg if isinstance(cfg, str) else "text_to_video")
    if name in ("video_to_video", "ic_lora"):
        return VideoToVideoStrategy(cfg if not isinstance(cfg, str) else None)
    return TextToVideoStrategy(cfg if not isinstance(cfg, str) else None)
