"""Per-component model loaders for the trainer and tooling.

Counterpart of mlx_video_tpu/trainer/model_loader.py: ``load_transformer``,
``load_video_vae_encoder``, ``load_video_vae_decoder``,
``load_audio_vae_decoder``, ``load_vocoder``, ``load_text_encoder``,
``ModelComponents`` and ``load_model``, with the reference-name aliases.
Each returns the port's module on ``device`` (default ``cuda``) with its
config, where the JAX functions return (params, config); the weights come
through the port's loaders (io/weights.py, io/vae_weights.py) over a seeded
init, as the JAX loaders fill theirs.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import torch

from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType, VideoVAEConfig


def _resolve(path) -> Path:
    return Path(path).expanduser().resolve()


def _generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def default_19b_config(model_type: LTXModelType = LTXModelType.VideoOnly) -> LTXModelConfig:
    """The 19B training configuration."""
    return LTXModelConfig(
        model_type=model_type,
        num_attention_heads=32,
        attention_head_dim=128,
        in_channels=128,
        out_channels=128,
        num_layers=48,
        cross_attention_dim=4096,
        caption_channels=3840,
        rope_type=LTXRopeType.SPLIT,
        double_precision_rope=True,
    )


def load_transformer(checkpoint_path, config: Optional[LTXModelConfig] = None, dtype=torch.bfloat16,
                     device="cuda") -> Tuple[torch.nn.Module, LTXModelConfig]:
    """The DiT from a safetensors file (or a directory of shards)."""
    from mlx_video_tpu_torch.io.weights import load_dit_params

    config = config or default_19b_config()
    path = _resolve(checkpoint_path)
    files = [path] if path.is_file() else sorted(path.glob("*.safetensors"))
    return load_dit_params(files, config, dtype=dtype, device=device), config


def load_video_vae_encoder(checkpoint_path, config=None, dtype=torch.bfloat16, device="cuda"):
    from mlx_video_tpu_torch.io.vae_weights import load_video_encoder_weights
    from mlx_video_tpu_torch.models.ltx.video_vae.encoder import init_video_encoder

    cfg = config or VideoVAEConfig()
    encoder = init_video_encoder(_generator(device), cfg, device=device, dtype=dtype)
    load_video_encoder_weights(_resolve(checkpoint_path), encoder)
    return encoder, cfg


def load_video_vae_decoder(checkpoint_path, config=None, dtype=torch.bfloat16, device="cuda"):
    from mlx_video_tpu_torch.io.vae_weights import load_video_decoder_weights
    from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, init_video_decoder

    cfg = config or DecoderConfig()
    decoder = init_video_decoder(_generator(device), cfg, device=device, dtype=dtype)
    load_video_decoder_weights(_resolve(checkpoint_path), decoder)
    return decoder, cfg


def load_audio_vae_decoder(checkpoint_path, config=None, dtype=torch.bfloat16, device="cuda"):
    from mlx_video_tpu_torch.io.vae_weights import load_audio_vae_weights
    from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import AudioVAEConfig, init_audio_decoder

    cfg = config or AudioVAEConfig()
    decoder = init_audio_decoder(_generator(device), cfg, device=device, dtype=dtype)
    load_audio_vae_weights(_resolve(checkpoint_path), decoder)
    return decoder, cfg


def load_vocoder(checkpoint_path, config=None, dtype=torch.bfloat16, device="cuda"):
    from mlx_video_tpu_torch.io.vae_weights import load_vocoder_weights
    from mlx_video_tpu_torch.models.ltx.audio_vae.vocoder import VocoderConfig, init_vocoder

    cfg = config or VocoderConfig()
    vocoder = init_vocoder(_generator(device), cfg, device=device, dtype=dtype)
    load_vocoder_weights(_resolve(checkpoint_path), vocoder)
    return vocoder, cfg


def load_text_encoder(checkpoint_path, text_encoder_path, dtype=torch.bfloat16, device="cuda"):
    from mlx_video_tpu_torch.models.ltx.text_encoder import LTX2TextEncoder

    return LTX2TextEncoder.load(_resolve(checkpoint_path), _resolve(text_encoder_path), dtype=dtype, device=device)


@dataclass
class ModelComponents:
    """The loaded components; each VAE part a (module, config) pair."""

    transformer: Optional[torch.nn.Module] = None
    transformer_config: Optional[LTXModelConfig] = None
    vae_encoder: Optional[tuple] = None
    vae_decoder: Optional[tuple] = None
    audio_decoder: Optional[tuple] = None
    vocoder: Optional[tuple] = None
    text_encoder: Optional[object] = None


MLXModelComponents = ModelComponents  # the reference's name


def load_model(
    model_path,
    config: Optional[LTXModelConfig] = None,
    kind: str = "dev",
    with_vae: bool = True,
    with_audio: bool = False,
    with_text_encoder: bool = False,
    text_encoder_path=None,
    dtype=torch.bfloat16,
    device="cuda",
) -> ModelComponents:
    """Everything the trainer needs from one snapshot: the ``kind`` DiT, the
    VAE encoder and decoder, with ``with_audio`` the audio VAE decoder
    (``audio_vae.safetensors`` or ``model.safetensors``) and the vocoder
    (``vocoder.safetensors``) where present, with ``with_text_encoder`` the
    text encoder."""
    from mlx_video_tpu_torch.loading import resolve_transformer_file, resolve_vae_file

    model_path = _resolve(model_path)
    out = ModelComponents()
    out.transformer, out.transformer_config = load_transformer(
        resolve_transformer_file(model_path, kind), config, dtype, device)
    if with_vae:
        vae_file = resolve_vae_file(model_path)
        out.vae_encoder = load_video_vae_encoder(vae_file, dtype=dtype, device=device)
        out.vae_decoder = load_video_vae_decoder(vae_file, dtype=dtype, device=device)
    if with_audio:
        for candidate in (model_path / "audio_vae.safetensors", model_path / "model.safetensors"):
            if candidate.exists():
                out.audio_decoder = load_audio_vae_decoder(candidate, dtype=dtype, device=device)
                break
        voc = model_path / "vocoder.safetensors"
        if voc.exists():
            out.vocoder = load_vocoder(voc, dtype=dtype, device=device)
    if with_text_encoder:
        out.text_encoder = load_text_encoder(model_path, text_encoder_path or model_path, dtype, device)
    return out


# the reference's names
load_vae_encoder = load_video_vae_encoder
load_vae_decoder = load_video_vae_decoder
load_audio_decoder = load_audio_vae_decoder
load_gemma = load_text_encoder
