"""Transformer-args re-export (reference: ltx_core/model/transformer/transformer_args.py).

The reference's ``TransformerArgs`` bundle maps onto the engine's ``Modality``
NamedTuple (latent, timesteps, context, positions, ...)."""

from mlx_video_tpu_torch.models.ltx.model import Modality

TransformerArgs = Modality

__all__ = ["Modality", "TransformerArgs"]
