"""(reference: ltx_trainer/training_strategies/video_to_video.py)."""

from mlx_video_tpu_torch.trainer.strategies import (  # noqa: F401
    ModelInputs,
    compute_loss,
    prepare_video_to_video,
)

from mlx_video_tpu_torch.ltx_trainer.training_strategies.base_strategy import TrainingStrategy


class VideoToVideoStrategy(TrainingStrategy):
    """IC-LoRA V2V with reference latents (reference: video_to_video.py)."""

    _prepare = staticmethod(prepare_video_to_video)

    def get_data_sources(self):
        return {
            "latents": "latents",
            "conditions": "conditions",
            "reference_latents": "ref_latents",
        }


__all__ = ["ModelInputs", "VideoToVideoStrategy", "compute_loss", "prepare_video_to_video"]
