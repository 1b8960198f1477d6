"""Gemma text-encoder parity import paths (reference:
ltx_core/text_encoders/gemma/*). The real implementation is
``mlx_video_tpu_torch.models.ltx.text_encoder.LTX2TextEncoder``; these names map
the reference's class split (AV vs video-only encoder models) onto it."""

from mlx_video_tpu_torch.models.ltx.text_encoder import LTX2TextEncoder

# The reference distinguishes AV and base encoder model classes
# (ltx_core/text_encoders/gemma/encoders/{av,base}_encoder.py); the
# encoder always produces both contexts, so both names resolve to it.
GemmaTextEncoderModelBase = LTX2TextEncoder
AVGemmaTextEncoderModel = LTX2TextEncoder

__all__ = ["AVGemmaTextEncoderModel", "GemmaTextEncoderModelBase", "LTX2TextEncoder"]
