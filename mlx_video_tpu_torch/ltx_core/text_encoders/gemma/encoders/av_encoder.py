"""(reference:
ltx_core/text_encoders/gemma/encoders/av_encoder.py)."""

from mlx_video_tpu_torch.ltx_core.text_encoders.gemma import AVGemmaTextEncoderModel

__all__ = ["AVGemmaTextEncoderModel"]
