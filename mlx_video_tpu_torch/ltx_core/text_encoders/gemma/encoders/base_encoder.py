"""(reference:
ltx_core/text_encoders/gemma/encoders/base_encoder.py)."""

from mlx_video_tpu_torch.ltx_core.text_encoders.gemma import GemmaTextEncoderModelBase

__all__ = ["GemmaTextEncoderModelBase"]
