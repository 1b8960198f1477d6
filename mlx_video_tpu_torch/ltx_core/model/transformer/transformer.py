"""AV transformer block re-export (reference:
ltx_core/model/transformer/transformer.py); the module class
``TransformerBlock`` stands for the JAX ``init_block``."""

from mlx_video_tpu_torch.models.ltx.model import Modality, TransformerBlock, block_apply

__all__ = ["Modality", "TransformerBlock", "block_apply"]
