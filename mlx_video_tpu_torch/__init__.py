"""PyTorch/CUDA port of mlx_video_tpu for NVIDIA Hopper GPUs.

Same module layout as the JAX package; see README.md "PyTorch / H100 port".
"""
