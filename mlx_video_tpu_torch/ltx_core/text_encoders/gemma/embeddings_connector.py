"""Embeddings connector (reference:
ltx_core/text_encoders/gemma/embeddings_connector.py). The connector (a
2-layer transformer + 128 learnable registers) is the module class
``Connector`` run by ``connector_apply`` in
mlx_video_tpu_torch/models/ltx/text_encoder.py; the class stands for the
JAX ``init_connector``."""

from mlx_video_tpu_torch.models.ltx.text_encoder import (
    Connector,
    connector_apply,
    connector_block_apply,
)

Embeddings1DConnector = connector_apply

__all__ = [
    "Connector",
    "Embeddings1DConnector",
    "connector_apply",
    "connector_block_apply",
]
