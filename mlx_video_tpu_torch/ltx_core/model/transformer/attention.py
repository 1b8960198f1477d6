"""Attention re-export (reference: ltx_core/model/transformer/attention.py);
the module class ``Attention`` stands for the JAX ``init_attention``."""

from mlx_video_tpu_torch.models.ltx.model import Attention, attention_apply
from mlx_video_tpu_torch.ops.attention import sdpa as scaled_dot_product_attention

__all__ = ["Attention", "attention_apply", "scaled_dot_product_attention"]
