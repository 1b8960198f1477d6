"""PyTorch/CUDA port of mlx_video_tpu for NVIDIA Hopper GPUs.

Same module layout as the JAX package; see README.md "PyTorch / H100 port".
The top-level exports are the JAX package's; the heavy ones import lazily,
so importing the package stays cheap for ``--help`` and tooling.
"""

from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType

__version__ = "0.1.0"

__all__ = [
    "LTXModelConfig",
    "LTXModelType",
    "LTXRopeType",
    "init_ltx_params",
    "ltx_apply",
    "load_dit_params",
    "generate_video",
    "__version__",
]


def __getattr__(name):
    if name in ("init_ltx_params", "ltx_apply"):
        from mlx_video_tpu_torch.models.ltx import model

        return getattr(model, name)
    if name == "load_dit_params":
        from mlx_video_tpu_torch.io.weights import load_dit_params

        return load_dit_params
    if name == "generate_video":
        from mlx_video_tpu_torch.pipelines.generate import generate_video

        return generate_video
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
