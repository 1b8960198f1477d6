"""Top-level model re-export (reference: ltx_core/model/transformer/model.py).

The reference exports ``LTXModel``/``X0Model`` classes; the engine's are the
module ``LTXModel`` built by ``init_ltx_params`` and run by ``ltx_apply``,
plus ``to_denoised`` (the X0 wrap: x0 = x - sigma*v,
mlx_video_tpu_torch/models/ltx/model.py).
"""

from mlx_video_tpu_torch.models.ltx.model import init_ltx_params, ltx_apply, to_denoised

__all__ = ["init_ltx_params", "ltx_apply", "to_denoised"]
