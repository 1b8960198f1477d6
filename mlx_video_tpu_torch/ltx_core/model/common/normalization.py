"""Normalization helpers (reference: ltx_core/model/common/normalization.py).

The engine-side implementation is the functional ``pixel_norm`` in
mlx_video_tpu_torch/models/ltx/video_vae/blocks.py; ``PixelNorm`` wraps it in a
callable object for reference-API users.
"""

from enum import Enum

from mlx_video_tpu_torch.models.ltx.video_vae.blocks import pixel_norm


class NormType(str, Enum):
    PIXEL_NORM = "pixel_norm"
    GROUP_NORM = "group_norm"
    LAYER_NORM = "layer_norm"


class PixelNorm:
    """Channel-wise RMS normalization over the channel axis."""

    def __init__(self, eps: float = 1e-6):
        self.eps = eps

    def __call__(self, x):
        return pixel_norm(x, eps=self.eps)


def build_normalization_layer(*_args, **_kwargs) -> PixelNorm:
    return PixelNorm()


__all__ = ["NormType", "PixelNorm", "build_normalization_layer", "pixel_norm"]
