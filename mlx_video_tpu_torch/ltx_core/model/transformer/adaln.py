"""adaLN re-export (reference: ltx_core/model/transformer/adaln.py, a
compatibility stub; the engine adaLN lives in
mlx_video_tpu_torch/models/ltx/model.py, where the module class
``AdaLayerNormSingle`` stands for the JAX ``init_adaln``)."""

from mlx_video_tpu_torch.models.ltx.model import AdaLayerNormSingle, adaln_apply, timestep_embedding

__all__ = ["AdaLayerNormSingle", "adaln_apply", "timestep_embedding"]
