"""Sigma schedules for the distilled and dev pipelines.

The port's own copy of mlx_video_tpu/pipelines/schedulers.py (framework-free code, copied whole and
unchanged in behaviour), so that the port imports nothing of the JAX package.

Behavioral spec: reference mlx_video/generate.py:182-467. Pure NumPy/Python —
schedules are tiny, computed host-side once, and baked into the jitted
denoise loop as static-length arrays.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

# Distilled model sigma schedules (reference: generate.py:338-340)
STAGE_1_SIGMAS = [1.0, 0.99375, 0.9875, 0.98125, 0.975, 0.909375, 0.725, 0.421875, 0.0]
STAGE_2_SIGMAS = [0.909375, 0.725, 0.421875, 0.0]

# Dev model scheduling constants (reference: generate.py:343-344)
BASE_SHIFT_ANCHOR = 1024
MAX_SHIFT_ANCHOR = 4096


def subsample_sigmas_farthest(sigmas: List[float], steps: int) -> List[float]:
    """Farthest-point subsampling in log-sigma space (reference: generate.py:182-221)."""
    if steps < 1:
        raise ValueError("steps must be >= 1")
    max_steps = len(sigmas) - 1
    if steps >= max_steps:
        return list(sigmas)
    if steps == 1:
        return [sigmas[0], sigmas[-1]]

    eps = 1e-6
    pool = sigmas[:-1]
    xs = [math.log(max(s, eps)) for s in pool]
    chosen = {0, len(pool) - 1}
    while len(chosen) < steps:
        best_i, best_score = None, -1.0
        for i in range(len(pool)):
            if i in chosen:
                continue
            score = min(abs(xs[i] - xs[j]) for j in chosen)
            if score > best_score:
                best_score, best_i = score, i
        assert best_i is not None
        chosen.add(best_i)
    return [sigmas[i] for i in sorted(chosen)] + [sigmas[-1]]


def subsample_sigmas_uniform(sigmas: List[float], steps: int) -> List[float]:
    """Uniform index subsampling (reference: generate.py:224-255)."""
    if steps < 1:
        raise ValueError("steps must be >= 1")
    max_steps = len(sigmas) - 1
    if steps >= max_steps:
        return list(sigmas)
    if steps == 1:
        return [sigmas[0], sigmas[-1]]

    pool = sigmas[:-1]
    last = len(pool) - 1
    idxs = [0] + [int(round(i * last / (steps - 1))) for i in range(1, steps - 1)] + [last]
    uniq = sorted(set(idxs))
    if len(uniq) < steps:
        for i in range(last + 1):
            if i not in uniq:
                uniq.append(i)
                if len(uniq) == steps:
                    break
        uniq = sorted(uniq)
    return [pool[i] for i in uniq] + [sigmas[-1]]


def subsample_sigmas(sigmas: List[float], steps: int, method: str = "farthest") -> List[float]:
    if method == "uniform":
        return subsample_sigmas_uniform(sigmas, steps)
    if method == "farthest":
        return subsample_sigmas_farthest(sigmas, steps)
    raise ValueError(f"Unknown sigma subsample method: {method}")


def subsample_refinement_sigmas(sigmas: List[float], steps: int, method: str = "farthest") -> List[float]:
    """Stage-2 variant: a single step starts at the last non-zero sigma
    (reference: generate.py:266-277)."""
    if steps == 1 and method == "farthest" and len(sigmas) >= 3:
        return [sigmas[-2], sigmas[-1]]
    return subsample_sigmas(sigmas, steps, method)


def ltx2_scheduler(
    steps: int,
    num_tokens: Optional[int] = None,
    max_shift: float = 2.05,
    base_shift: float = 0.95,
    stretch: bool = True,
    terminal: float = 0.1,
) -> np.ndarray:
    """Dev-model sigma schedule with token-count shift + terminal stretch
    (reference: generate.py:410-467). Returns float32 array of shape (steps+1,).
    """
    tokens = MAX_SHIFT_ANCHOR if num_tokens is None else min(num_tokens, MAX_SHIFT_ANCHOR)
    sigmas = np.linspace(1.0, 0.0, steps + 1)

    mm = (max_shift - base_shift) / (MAX_SHIFT_ANCHOR - BASE_SHIFT_ANCHOR)
    b = base_shift - mm * BASE_SHIFT_ANCHOR
    sigma_shift = tokens * mm + b

    transformed = np.zeros_like(sigmas)
    non_zero = sigmas != 0
    if np.any(non_zero):
        nz = sigmas[non_zero]
        transformed[non_zero] = math.exp(sigma_shift) / (math.exp(sigma_shift) + (1 / nz - 1))
    sigmas = transformed

    if stretch:
        non_zero_mask = sigmas != 0
        non_zero_sigmas = sigmas[non_zero_mask]
        one_minus_z = 1.0 - non_zero_sigmas
        scale_factor = one_minus_z[-1] / (1.0 - terminal)
        if np.isfinite(scale_factor) and scale_factor != 0:
            sigmas[non_zero_mask] = 1.0 - (one_minus_z / scale_factor)

    return sigmas.astype(np.float32)


def cfg_delta(cond, uncond, scale: float):
    """(scale - 1) * (cond - uncond) (reference: generate.py:382-393)."""
    return (scale - 1.0) * (cond - uncond)
