"""Custom-kernel registry compat (reference: ltx_core/loader/kernels.py, a
stub; the port's hand-written CUDA kernels live in mlx_video_tpu_torch/csrc/
and are built by ops/_build.py)."""

__all__ = []
