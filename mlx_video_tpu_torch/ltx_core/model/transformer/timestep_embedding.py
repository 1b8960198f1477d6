"""Timestep-embedding re-export (reference:
ltx_core/model/transformer/timestep_embedding.py)."""

from mlx_video_tpu_torch.models.ltx.model import timestep_embedding

# Reference-name alias (PixArt-alpha combined timestep embedding).
PixArtAlphaCombinedTimestepSizeEmbeddings = timestep_embedding

__all__ = ["PixArtAlphaCombinedTimestepSizeEmbeddings", "timestep_embedding"]
