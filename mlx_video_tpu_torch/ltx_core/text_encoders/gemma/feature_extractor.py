"""Feature extractor parity import path (reference:
ltx_core/text_encoders/gemma/feature_extractor.py)."""

from mlx_video_tpu_torch.models.ltx.text_encoder import norm_and_concat_hidden_states

# Reference name for the 49-state concat + linear projection module.
GemmaFeaturesExtractorProjLinear = norm_and_concat_hidden_states

__all__ = ["GemmaFeaturesExtractorProjLinear", "norm_and_concat_hidden_states"]
