"""Shim onto the port's trainer (reference: ltx_trainer/model_loader.py)."""

from mlx_video_tpu_torch.io.weights import load_dit_params, load_native_params  # noqa: F401
from mlx_video_tpu_torch.trainer.model_loader import (  # noqa: F401
    MLXModelComponents,
    ModelComponents,
    default_19b_config,
    load_audio_vae_decoder,
    load_model,
    load_text_encoder,
    load_transformer,
    load_video_vae_decoder,
    load_video_vae_encoder,
    load_vocoder,
)
