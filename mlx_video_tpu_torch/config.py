"""Model configuration for the LTX-2 audio-video diffusion transformer.

The port's own copy of mlx_video_tpu/config.py (framework-free code, copied whole and
unchanged in behaviour), so that the port imports nothing of the JAX package.

TPU-native re-design of the reference configuration surface
(reference: mlx_video/models/ltx/config.py:8-182). The field names and
defaults match the reference so checkpoints and YAML configs interop, but the
implementation here is plain dataclasses consumed by pure-functional JAX
model code.
"""

from __future__ import annotations

import dataclasses
import enum
import inspect
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple


class LTXModelType(enum.Enum):
    AudioVideo = "ltx av model"
    VideoOnly = "ltx video only model"
    AudioOnly = "ltx audio only model"

    @property
    def video_enabled(self) -> bool:
        return self in (LTXModelType.AudioVideo, LTXModelType.VideoOnly)

    @property
    def audio_enabled(self) -> bool:
        return self in (LTXModelType.AudioVideo, LTXModelType.AudioOnly)


class LTXRopeType(enum.Enum):
    INTERLEAVED = "interleaved"
    SPLIT = "split"
    TWO_D = "2d"


@dataclass(frozen=True)
class TransformerConfig:
    """Per-modality transformer geometry."""

    dim: int
    heads: int
    d_head: int
    context_dim: int


def _filtered_kwargs(cls, params: dict) -> dict:
    valid = inspect.signature(cls).parameters
    return {k: v for k, v in params.items() if k in valid}


@dataclass(frozen=True)
class VideoVAEConfig:
    """Causal video VAE geometry (reference: mlx_video/models/ltx/config.py:65-90)."""

    convolution_dimensions: int = 3
    in_channels: int = 3
    out_channels: int = 128
    latent_channels: int = 128
    patch_size: int = 4
    encoder_blocks: Tuple[Tuple[str, dict], ...] = (
        ("res_x", {"num_layers": 4}),
        ("compress_space_res", {"multiplier": 2}),
        ("res_x", {"num_layers": 6}),
        ("compress_time_res", {"multiplier": 2}),
        ("res_x", {"num_layers": 6}),
        ("compress_all_res", {"multiplier": 2}),
        ("res_x", {"num_layers": 2}),
        ("compress_all_res", {"multiplier": 2}),
        ("res_x", {"num_layers": 2}),
    )
    decoder_blocks: Tuple[Tuple[str, dict], ...] = (
        ("res_x", {"num_layers": 5, "inject_noise": False}),
        ("compress_all", {"residual": True, "multiplier": 2}),
        ("res_x", {"num_layers": 5, "inject_noise": False}),
        ("compress_all", {"residual": True, "multiplier": 2}),
        ("res_x", {"num_layers": 5, "inject_noise": False}),
        ("compress_all", {"residual": True, "multiplier": 2}),
        ("res_x", {"num_layers": 5, "inject_noise": False}),
    )

    @classmethod
    def from_dict(cls, params: dict) -> "VideoVAEConfig":
        kw = _filtered_kwargs(cls, params)
        for key in ("encoder_blocks", "decoder_blocks"):
            if key in kw:
                kw[key] = tuple((name, dict(cfg)) for name, cfg in kw[key])
        return cls(**kw)

    def __hash__(self) -> int:
        # The block-spec tuples contain dicts (unhashable); hash the repr so
        # the config can be a jit static argument.
        return hash(repr(self))


@dataclass(frozen=True)
class LTXModelConfig:
    """Full LTX-2 DiT configuration.

    Defaults correspond to the released 19B audio-video checkpoint
    (reference: mlx_video/models/ltx/config.py:94-182).
    """

    model_type: LTXModelType = LTXModelType.AudioVideo

    # Video transformer
    num_attention_heads: int = 32
    attention_head_dim: int = 128
    in_channels: int = 128
    out_channels: int = 128
    num_layers: int = 48
    cross_attention_dim: int = 4096
    caption_channels: int = 3840

    # Audio transformer
    audio_num_attention_heads: int = 32
    audio_attention_head_dim: int = 64
    audio_in_channels: int = 128
    audio_out_channels: int = 128
    audio_cross_attention_dim: int = 2048
    audio_caption_channels: int = 3840

    # Positional embedding
    positional_embedding_theta: float = 10000.0
    positional_embedding_max_pos: Tuple[int, ...] = (20, 2048, 2048)
    audio_positional_embedding_max_pos: Tuple[int, ...] = (20,)
    use_middle_indices_grid: bool = True
    rope_type: LTXRopeType = LTXRopeType.INTERLEAVED
    double_precision_rope: bool = False

    # Timestep scaling
    timestep_scale_multiplier: int = 1000
    av_ca_timestep_scale_multiplier: int = 1000

    norm_eps: float = 1e-6

    # Rematerialize each transformer block on the backward pass
    # (jax.checkpoint around the scanned block body) — trades ~1/3 more
    # FLOPs for O(1) activation memory per block, the standard recipe for
    # finetuning the 19B model on limited HBM. New TPU capability; the
    # reference trains without remat on unified memory.
    gradient_checkpointing: bool = False

    vae_config: Optional[VideoVAEConfig] = None

    @classmethod
    def from_dict(cls, params: dict) -> "LTXModelConfig":
        kw = _filtered_kwargs(cls, params)
        if isinstance(kw.get("model_type"), str):
            kw["model_type"] = LTXModelType(kw["model_type"])
        if isinstance(kw.get("rope_type"), str):
            kw["rope_type"] = LTXRopeType(kw["rope_type"])
        for key in ("positional_embedding_max_pos", "audio_positional_embedding_max_pos"):
            if key in kw and kw[key] is not None:
                kw[key] = tuple(kw[key])
        if isinstance(kw.get("vae_config"), dict):
            kw["vae_config"] = VideoVAEConfig.from_dict(kw["vae_config"])
        return cls(**kw)

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if isinstance(v, enum.Enum):
                out[f.name] = v.value
            elif isinstance(v, VideoVAEConfig):
                out[f.name] = dataclasses.asdict(v)
            elif isinstance(v, tuple):
                out[f.name] = list(v)
            else:
                out[f.name] = v
        return out

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def audio_inner_dim(self) -> int:
        return self.audio_num_attention_heads * self.audio_attention_head_dim

    def get_video_config(self) -> Optional[TransformerConfig]:
        if not self.model_type.video_enabled:
            return None
        return TransformerConfig(
            dim=self.inner_dim,
            heads=self.num_attention_heads,
            d_head=self.attention_head_dim,
            context_dim=self.cross_attention_dim,
        )

    def get_audio_config(self) -> Optional[TransformerConfig]:
        if not self.model_type.audio_enabled:
            return None
        return TransformerConfig(
            dim=self.audio_inner_dim,
            heads=self.audio_num_attention_heads,
            d_head=self.audio_attention_head_dim,
            context_dim=self.audio_cross_attention_dim,
        )


def tiny_test_config(
    model_type: LTXModelType = LTXModelType.VideoOnly,
    rope_type: LTXRopeType = LTXRopeType.INTERLEAVED,
    num_layers: int = 2,
) -> LTXModelConfig:
    """A miniature config for unit tests and compile checks."""
    return LTXModelConfig(
        model_type=model_type,
        num_attention_heads=4,
        attention_head_dim=32,
        in_channels=16,
        out_channels=16,
        num_layers=num_layers,
        cross_attention_dim=128,
        caption_channels=48,
        audio_num_attention_heads=4,
        audio_attention_head_dim=16,
        audio_in_channels=8,
        audio_out_channels=8,
        audio_cross_attention_dim=64,
        audio_caption_channels=48,
        rope_type=rope_type,
    )
