"""(reference: ltx_trainer/training_strategies/text_to_video.py)."""

from mlx_video_tpu_torch.trainer.strategies import (  # noqa: F401
    ModelInputs,
    compute_loss,
    prepare_text_to_video,
)

from mlx_video_tpu_torch.ltx_trainer.training_strategies.base_strategy import TrainingStrategy


class TextToVideoStrategy(TrainingStrategy):
    """Flow-matching T2V (reference: text_to_video.py:35-127)."""

    _prepare = staticmethod(prepare_text_to_video)

    def get_data_sources(self):
        sources = {"latents": "latents", "conditions": "conditions"}
        if self.requires_audio:
            sources["audio_latents"] = "audio_latents"
        return sources


__all__ = ["ModelInputs", "TextToVideoStrategy", "compute_loss", "prepare_text_to_video"]
