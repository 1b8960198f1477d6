"""K1, the flash-attention forward (flash_fwd_kernel), self-attention over
(B, S, H, D) bf16. Copied from chip_smoke.py:attention_fwd_work (commit
c91ea08); ``lse`` adds the fp32 log-sum-exp rows a training forward
writes."""

KERNEL = "flash_fwd"


def work(b: int, s: int, h: int, d: int, lse: bool = False):
    """Two S x S x D products a head; q, k, v read, o (bf16) written."""
    return 4.0 * b * s * s * d * h, b * (4 * s * h * d * 2 + (s * h * 4 if lse else 0))
