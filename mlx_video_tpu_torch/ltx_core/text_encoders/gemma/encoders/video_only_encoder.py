"""(reference:
ltx_core/text_encoders/gemma/encoders/video_only_encoder.py)."""

from mlx_video_tpu_torch.ltx_core.text_encoders.gemma import GemmaTextEncoderModelBase

VideoOnlyGemmaTextEncoderModel = GemmaTextEncoderModelBase

__all__ = ["VideoOnlyGemmaTextEncoderModel"]
