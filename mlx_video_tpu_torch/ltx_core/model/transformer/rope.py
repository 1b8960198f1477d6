"""RoPE re-export (reference: ltx_core/model/transformer/rope.py)."""

from mlx_video_tpu_torch.config import LTXRopeType
from mlx_video_tpu_torch.models.ltx.rope import (
    apply_rotary_emb,
    interleaved_freqs_cis,
    precompute_freqs_cis,
    split_freqs_cis,
)

__all__ = [
    "LTXRopeType",
    "apply_rotary_emb",
    "interleaved_freqs_cis",
    "precompute_freqs_cis",
    "split_freqs_cis",
]
