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

The backward (:class:`_RingAttention`, under autograd) is a second pass
round the same ring: this rank's q, o, dO and the forward's global
logsumexp stay; each key block goes round again with its dK and dV
accumulators, and every rank adds its block's share,
ops/flash_attention.py:flash_attention_bwd with the global lse and o (so
p = exp(scale q k^T - lse) and D = rowsum(dO o) are the whole attention's).
On CUDA tensors that share is K3 (its dq and dkv kernels, one launch count
a block: n a rank, n^2 over the ring); on CPU tensors its plain version,
which recomputes p from q, k and the lse, as JAX's recompute backward
(``_local_stats_flash_bwd``) does. After n steps the accumulators have
come back to the ranks that own their blocks. The sums run in fp32, in
ring order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mlx_video_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd


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


def _ring_forward(q, k, v, group, scale: float, local_stats):
    """The ring's output (q's dtype) and its global logsumexp (B, H, Sq)
    fp32."""
    n = group.size
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
    return out.permute(0, 2, 1, 3).to(q.dtype), m + torch.log(l)


def ring_attention_bwd(q, k, v, o, lse, do, group, scale: float):
    """dQ, dK, dV of this rank's blocks (B, S/n, H, D) from the ring's
    output ``o``, its global ``lse`` (B, H, S/n) and ``do``: the module
    docstring's reverse pass. Returned in the dtypes of q, k and v."""
    n = group.size
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_cur, v_cur = k, v
    for step in range(n):
        dq_b, dk_b, dv_b = flash_attention_bwd(q, k_cur, v_cur, o, lse, do, scale)
        dq += dq_b.float()
        dk_cur, dv_cur = dk_cur + dk_b.float(), dv_cur + dv_b.float()
        if step + 1 < n:
            k_cur, v_cur = group.ring_shift(k_cur), group.ring_shift(v_cur)
        dk_cur, dv_cur = group.ring_shift(dk_cur), group.ring_shift(dv_cur)  # n shifts: home again
    return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale: float, local_stats):
        out, lse = _ring_forward(q, k, v, group, scale, local_stats)
        ctx.save_for_backward(q, k, v, out, lse.contiguous())
        ctx.group, ctx.scale = group, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_attention_bwd(q, k, v, out, lse, do, ctx.group, ctx.scale)
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group, scale: Optional[float] = None,
                   seq_len: Optional[int] = None, local_stats=None) -> torch.Tensor:
    """Full bidirectional attention with the token axis sharded over
    ``group`` (parallel/collectives.py): q/k/v are this rank's (B, S/n, H, D)
    blocks of a (B, S, H, D) sequence; returns this rank's block of the
    output, in q's dtype, differentiable in q, k and v (the ring backward of
    the module docstring). ``seq_len`` (the whole S) is checked to divide
    over the ring. ``local_stats`` replaces the local step chosen by the
    device (the card's smoke runs the plain one there as a reference)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = group.size
    if seq_len is not None and seq_len % n != 0:
        raise ValueError(f"Sequence length {seq_len} not divisible by mesh axis fsdp={n}")
    if local_stats is None:
        local_stats = _local_stats_flash if q.device.type == "cuda" else _local_attention_stats
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _RingAttention.apply(q, k, v, group, scale, local_stats)
    return _ring_forward(q, k, v, group, scale, local_stats)[0]
