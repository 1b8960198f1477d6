"""Ring attention: sequence-parallel self-attention over a mesh axis.

Counterpart of mlx_video_tpu/parallel/ring_attention.py. Each rank holds
S/n tokens of q, k and v; k and v go round the ring (each rank sends its
block to the next and takes the previous one's, n steps), and each step's
local attention merges into an online softmax, the flash kernel's own
arithmetic with its key loop spread over the ranks.

The local step: on CUDA tensors K1 with its logsumexp
(ops/flash_attention.py:flash_attention(..., return_lse=True)), whose
normalized output and lse are the partials acc = out (fp32), m = lse, l = 1
(:func:`_local_stats_flash`); on CPU tensors the plain fp32 statistics
(:func:`_local_attention_stats`), as JAX runs them there. JAX's gate on
the TPU layout (D % 128, S/n >= 256) is dropped, as K1's route dropped it.
A ring of n ranks launches n K1 a rank, n^2 over the ring.

Inference only: no backward (the ring backward comes with the sharded
trainer).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mlx_video_tpu_torch.ops.flash_attention import flash_attention


def _local_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """Blockwise attention returning (acc, running max, running sum): q
    (B, Sq, H, D), k/v (B, Sk, H, D); logits and statistics in fp32, the
    products of the input dtype accumulated in fp32."""
    logits = scale * torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    m = torch.amax(logits, dim=-1)  # (B, H, Sq)
    p = torch.exp(logits - m[..., None])
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return acc, m, l


def _local_stats_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """K1 (with its lse) as online-softmax partials: its normalized output
    with m = lse and l = 1 merges as the plain statistics do."""
    out, lse = flash_attention(q, k, v, scale=scale, return_lse=True)
    acc = out.float().permute(0, 2, 1, 3)  # (B, H, Sq, D)
    return acc, lse, torch.ones_like(lse)


def _combine(m_a, l_a, acc_a, m_b, l_b, acc_b) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge two online-softmax partials."""
    m = torch.maximum(m_a, m_b)
    alpha_a = torch.exp(m_a - m)
    alpha_b = torch.exp(m_b - m)
    l = l_a * alpha_a + l_b * alpha_b
    acc = acc_a * alpha_a[..., None] + acc_b * alpha_b[..., None]
    return m, l, acc


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group, scale: Optional[float] = None,
                   seq_len: Optional[int] = None, local_stats=None) -> torch.Tensor:
    """Full bidirectional attention with the token axis sharded over
    ``group`` (parallel/collectives.py): q/k/v are this rank's (B, S/n, H, D)
    blocks of a (B, S, H, D) sequence; returns this rank's block of the
    output, in q's dtype. ``seq_len`` (the whole S) is checked to divide
    over the ring. ``local_stats`` replaces the local step chosen by the
    device (the card's smoke runs the plain one there as a reference)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = group.size
    if seq_len is not None and seq_len % n != 0:
        raise ValueError(f"Sequence length {seq_len} not divisible by mesh axis fsdp={n}")
    if local_stats is None:
        local_stats = _local_stats_flash if q.device.type == "cuda" else _local_attention_stats
    b, sq, h, d = q.shape
    m = torch.full((b, h, sq), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        acc_b, m_b, l_b = local_stats(q, k_cur, v_cur, scale)
        m, l, acc = _combine(m, l, acc, m_b, l_b, acc_b)
        if step + 1 < n:  # the last rotation would only bring back this rank's own block
            k_cur, v_cur = group.ring_shift(k_cur), group.ring_shift(v_cur)
    out = acc / l[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)
