"""Quantized Gemma text-encoder support (reference: ltx_trainer/gemma_8bit.py
-> mlx_video/mlx_trainer/gemma_8bit.py).

The port's text encoder loads MLX-format quantized Gemma checkpoints
(mlx_video_tpu_torch/io/text_encoder_weights.py); this module exposes that
path under the reference's name."""

from mlx_video_tpu_torch.models.ltx.text_encoder import LTX2TextEncoder  # noqa: F401


def load_gemma_8bit(model_path, **kwargs):
    """Load the text encoder from an 8-bit (quantized) checkpoint, on the
    card unless ``device`` says otherwise."""
    return LTX2TextEncoder.load(model_path, model_path, **kwargs)
