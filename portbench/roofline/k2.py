"""K2, the dequantizing matmul (quant_matmul_kernel): x (M, K) bf16 times a
packed (N, K) weight, y (M, N) bf16. Copied from
chip_smoke.py:quant_matmul_work (commit c91ea08), with the scales' and
biases' element size a parameter (4 bytes fp32, 2 bytes bf16)."""

KERNEL = "quant_matmul"


def work(m: int, k: int, n: int, bits: int, group: int, scale_bytes: int = 4):
    """2 M K N operations; x, the words, the scales and biases read once,
    y written once."""
    return 2.0 * m * k * n, m * k * 2 + n * k * bits // 8 + 2 * n * (k // group) * scale_bytes + m * n * 2
