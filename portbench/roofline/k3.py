"""K3, the flash-attention backward (flash_bwd_dq_kernel and
flash_bwd_dkv_kernel) over (1, S, H, D) bf16. Copied from
chip_smoke.py:attention_bwd_work (commit c91ea08)."""

KERNEL = "flash_bwd"


def work(s: int, h: int, d: int):
    """The five S x S x D products a head the gradients need; q, k, v, o,
    dO and lse read, dq, dk, dv written."""
    return 10.0 * s * s * d * h, 8 * s * h * d * 2 + s * h * 4
