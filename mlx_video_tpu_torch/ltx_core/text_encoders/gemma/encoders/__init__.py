"""(reference: ltx_core/text_encoders/gemma/encoders/)."""

from mlx_video_tpu_torch.ltx_core.text_encoders.gemma import (
    AVGemmaTextEncoderModel,
    GemmaTextEncoderModelBase,
)

__all__ = ["AVGemmaTextEncoderModel", "GemmaTextEncoderModelBase"]
