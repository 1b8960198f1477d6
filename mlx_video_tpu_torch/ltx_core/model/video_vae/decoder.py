"""Decoder re-export (reference: ltx_core/model/video_vae/decoder.py); the
module class ``TimeEmbedder`` stands for the JAX ``init_time_embedder``.
The port's ``video_decoder_apply`` decodes every frame at once (the JAX
``video_decoder_apply_chunked`` bounds an accelerator's memory by chunks)."""

from mlx_video_tpu_torch.models.ltx.video_vae.decoder import (
    DecoderConfig,
    TimeEmbedder,
    init_video_decoder,
    time_embedder_apply,
    video_decoder_apply,
)

__all__ = [
    "DecoderConfig",
    "TimeEmbedder",
    "init_video_decoder",
    "time_embedder_apply",
    "video_decoder_apply",
]
