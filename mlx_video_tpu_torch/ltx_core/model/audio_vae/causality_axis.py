"""Causality axis enum (reference: ltx_core/model/audio_vae/causality_axis.py)."""

from enum import Enum


class CausalityAxis(str, Enum):
    """Which spectrogram axis carries causal (one-sided) padding."""

    NONE = "none"
    HEIGHT = "height"
    WIDTH = "width"


__all__ = ["CausalityAxis"]
