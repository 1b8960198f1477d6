"""Audio attention block re-export (reference: ltx_core/model/audio_vae/attention.py);
the module class ``AttnBlock`` stands for the JAX ``init_attn_block``."""

from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import AttnBlock, attn_block

__all__ = ["AttnBlock", "attn_block"]
