"""3D fractional-position rotary embeddings for LTX-2, in fp32.

Counterpart of mlx_video_tpu/models/ltx/rope.py (see its docstring for the
position and frequency conventions). All table and rotation math is fp32
whatever the model dtype; ``double_precision`` is accepted and, as in the JAX
package, computes in fp32 too.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from mlx_video_tpu_torch.config import LTXRopeType
from mlx_video_tpu_torch.ops.flash_attention import rotate_split

FreqsCis = Tuple[torch.Tensor, torch.Tensor]


def generate_freq_grid(theta: float, n_pos_dims: int, dim: int, device=None) -> torch.Tensor:
    """Log-spaced frequency indices theta**linspace(0, 1, n) * pi/2, fp32.

    The largest index is ~1.6e4, so one ulp of the exponent moves it by ~1e-3
    and the RoPE angle with it. To land on the JAX package's fp32 values the
    linspace is i * fp32(1/(n-1)) (the form XLA evaluates ``jnp.linspace``
    in) and the power is rounded once to fp32 from fp64.
    """
    num_indices = max(dim // (2 * n_pos_dims), 1)
    lin = torch.arange(num_indices, dtype=torch.float32, device=device)
    if num_indices > 1:
        lin = lin * torch.tensor(1.0 / (num_indices - 1), dtype=torch.float32, device=device)
        lin[-1] = 1.0
    grid = torch.pow(torch.tensor(theta, dtype=torch.float64, device=device), lin.double()).float()
    return grid * (math.pi / 2)


def _resolve_middle(indices_grid: torch.Tensor, use_middle_indices_grid: bool) -> torch.Tensor:
    """Collapse (B, n_dims, S, 2) interval bounds to (B, n_dims, S) positions."""
    if use_middle_indices_grid:
        if indices_grid.dim() != 4 or indices_grid.shape[-1] != 2:
            raise ValueError(
                f"middle-indices grid requires shape (B, n_dims, S, 2), got {tuple(indices_grid.shape)}"
            )
        return (indices_grid[..., 0] + indices_grid[..., 1]) * 0.5
    if indices_grid.dim() == 4:
        return indices_grid[..., 0]
    return indices_grid


def generate_freqs(
    indices: torch.Tensor,
    indices_grid: torch.Tensor,
    max_pos: Sequence[int],
    use_middle_indices_grid: bool,
) -> torch.Tensor:
    """Per-token frequency arguments (B, S, num_indices * n_dims), frequency
    index slower-varying so each frequency's t/h/w components are adjacent."""
    grid = _resolve_middle(indices_grid.float(), use_middle_indices_grid)
    n_pos_dims = grid.shape[1]
    if n_pos_dims != len(max_pos):
        raise ValueError(
            f"Number of position dims ({n_pos_dims}) must match max_pos length ({len(max_pos)})"
        )
    max_pos_t = torch.tensor(list(max_pos), dtype=torch.float32, device=grid.device).reshape(1, -1, 1)
    scaled = torch.movedim(grid / max_pos_t, 1, -1) * 2.0 - 1.0  # (B, S, n_dims) in [-1, 1]
    freqs = scaled[..., None] * indices  # (B, S, n_dims, num_indices)
    freqs = freqs.transpose(-1, -2)
    return freqs.reshape(freqs.shape[0], freqs.shape[1], -1)


def _front_pad(cos: torch.Tensor, sin: torch.Tensor, pad_size: int) -> FreqsCis:
    if pad_size == 0:
        return cos, sin
    shape = (*cos.shape[:-1], pad_size)
    return (
        torch.cat([torch.ones(shape, dtype=cos.dtype, device=cos.device), cos], dim=-1),
        torch.cat([torch.zeros(shape, dtype=sin.dtype, device=sin.device), sin], dim=-1),
    )


def interleaved_freqs_cis(freqs: torch.Tensor, pad_size: int) -> FreqsCis:
    """(cos, sin) of shape (B, S, dim) for interleaved RoPE."""
    cos = torch.repeat_interleave(torch.cos(freqs), 2, dim=-1)
    sin = torch.repeat_interleave(torch.sin(freqs), 2, dim=-1)
    return _front_pad(cos, sin, pad_size)


def split_freqs_cis(freqs: torch.Tensor, pad_size: int, num_attention_heads: int) -> FreqsCis:
    """(cos, sin) of shape (B, H, S, D/2) for split RoPE."""
    cos, sin = _front_pad(torch.cos(freqs), torch.sin(freqs), pad_size)
    b, s = cos.shape[0], cos.shape[1]
    cos = cos.reshape(b, s, num_attention_heads, -1).transpose(1, 2)
    sin = sin.reshape(b, s, num_attention_heads, -1).transpose(1, 2)
    return cos, sin


def precompute_freqs_cis(
    indices_grid: torch.Tensor,
    dim: int,
    theta: float = 10000.0,
    max_pos: Optional[Sequence[int]] = None,
    use_middle_indices_grid: bool = False,
    num_attention_heads: int = 32,
    rope_type: LTXRopeType = LTXRopeType.INTERLEAVED,
    double_precision: bool = False,
) -> FreqsCis:
    """RoPE (cos, sin) tables from (B, n_dims, S, 2) pixel-space positions."""
    del double_precision  # fp32 everywhere, as the JAX package
    if max_pos is None:
        max_pos = [20, 2048, 2048]
    n_pos_dims = indices_grid.shape[1]
    indices = generate_freq_grid(theta, n_pos_dims, dim, device=indices_grid.device)
    freqs = generate_freqs(indices, indices_grid, max_pos, use_middle_indices_grid)
    if rope_type == LTXRopeType.SPLIT:
        return split_freqs_cis(freqs, dim // 2 - freqs.shape[-1], num_attention_heads)
    if rope_type == LTXRopeType.INTERLEAVED:
        return interleaved_freqs_cis(freqs, dim % (2 * n_pos_dims))
    raise ValueError(f"Unsupported rope type: {rope_type}")


def apply_interleaved_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Adjacent-pair rotation over the flattened hidden dim:
    x * cos + [-x1, x0, -x3, x2, ...] * sin."""
    xf = x.float()
    pairs = xf.reshape(*xf.shape[:-1], -1, 2)
    rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(xf.shape)
    return (xf * cos.float() + rotated * sin.float()).to(x.dtype)


def apply_split_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-dim rotation with per-head (B, H, S, D/2) frequencies, in fp32
    (ops/flash_attention.py:rotate_split, whose arithmetic K5 repeats). x is
    (B, H, S, D) or the flattened (B, S, H*D), which is reshaped around the
    rotation."""
    if x.dim() == 4:
        return rotate_split(x.transpose(1, 2), cos, sin).transpose(1, 2)
    b, h, s, _ = cos.shape
    return rotate_split(x.reshape(b, s, h, -1), cos, sin).reshape(x.shape)


def apply_rotary_emb(
    x: torch.Tensor, freqs_cis: FreqsCis, rope_type: LTXRopeType = LTXRopeType.INTERLEAVED
) -> torch.Tensor:
    if rope_type == LTXRopeType.INTERLEAVED:
        return apply_interleaved_rotary_emb(x, freqs_cis[0], freqs_cis[1])
    if rope_type == LTXRopeType.SPLIT:
        return apply_split_rotary_emb(x, freqs_cis[0], freqs_cis[1])
    raise ValueError(f"Unsupported rope type: {rope_type}")
