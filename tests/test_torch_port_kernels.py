"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs where JAX is not installed, without the repo's
conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_port_kernels.py

Bars, flash attention: max |d o| <= 2e-2 (the bf16 output rounds to one ulp,
1.6e-2 at |o| ~ 2-4) and max |d lse| <= 1e-3 (fp32 sums in another order).
Dequantizing matmul: max |d y| <= 1e-2 * max |y| and relative L2 <= 1e-3;
both sides multiply the same bf16 weights, only the summation order and the
bf16 rounding of y differ. The L2 bar separates a kernel that rounds fp32
scales and biases to bf16 before the affine (the Pallas kernel's way): that
moves y by more (test_quant_kernel_bar_rejects_bf16_rounded_scales).
"""

import pytest
import torch

from mlx_video_tpu_torch.ops import flash_attention as fa
from mlx_video_tpu_torch.ops import quant_matmul as qmm
from mlx_video_tpu_torch.ops.quant import quantize_affine


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _bf16(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)


def _check(out, ref):
    (o, lse), (ro, rlse) = out, ref
    assert o.shape == ro.shape and o.dtype == torch.bfloat16
    assert (o.float() - ro.float()).abs().max().item() <= 2e-2
    assert lse.shape == rlse.shape and (lse - rlse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b, s, h, d", [
    (1, 320, 32, 128), (1, 1280, 8, 128), (2, 1000, 4, 128), (1, 1, 2, 128),
    (1, 63, 3, 64), (1, 65, 3, 64), (2, 700, 4, 64),
])
def test_kernel_matches_plain(gen, b, s, h, d):
    q, k, v = (_bf16(gen, b, s, h, d) for _ in range(3))
    before = fa.launch_count
    out = fa.flash_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert fa.launch_count == before + 1
    _check(out, fa.flash_attention_reference(q, k, v, d**-0.5, return_lse=True))


@pytest.mark.cuda
def test_kernel_reads_strided_operands_in_place(gen):
    """q, k, v as views of one fused (B, S, 3, H, D) projection."""
    qkv = _bf16(gen, 2, 300, 3, 4, 128)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v, scale=0.05, return_lse=True)
    _check(out, fa.flash_attention_reference(q, k, v, 0.05, return_lse=True))


@pytest.mark.cuda
def test_kernel_is_exact_past_the_tpu_clamp(gen):
    """Scaled logits of ~100: the Pallas single-pass body would saturate."""
    q, k = (_bf16(gen, 1, 512, 2, 128) * 10 for _ in range(2))
    v = _bf16(gen, 1, 512, 2, 128)
    _check(fa.flash_attention(q, k, v, return_lse=True),
           fa.flash_attention_reference(q, k, v, 128**-0.5, return_lse=True))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(gen):
    q = torch.zeros(1, 64, 2, 128, device="cuda")
    before = fa.launch_count
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q, q, q)
    q = q.to(torch.bfloat16)[..., :96]
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    assert fa.launch_count == before


def _quantized(gen, m, k, n, bits, group, scale_dtype=torch.float32):
    x = _bf16(gen, m, k)
    w = torch.randn(n, k, generator=gen, device="cuda") * k**-0.5
    packed, scales, biases = quantize_affine(w, group, bits)
    return x, packed, scales.to(scale_dtype), biases.to(scale_dtype)


def _check_qmm(y, ref):
    assert y.shape == ref.shape and y.dtype == ref.dtype == torch.bfloat16
    d = (y.float() - ref.float())
    assert d.abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    assert (d.norm() / ref.float().norm()).item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n, bits, group", [
    (320, 4096, 4096, 4, 64), (128, 4096, 4096, 4, 64), (300, 4096, 16384, 4, 64),
    (1280, 16384, 4096, 4, 64), (77, 512, 200, 8, 128), (1, 256, 64, 2, 32),
    (5, 96, 130, 4, 32), (5, 96, 130, 4, 16), (33, 1024, 96, 8, 256),
])
def test_quant_kernel_matches_plain(gen, m, k, n, bits, group):
    x, packed, scales, biases = _quantized(gen, m, k, n, bits, group)
    before = qmm.launch_count
    y = qmm.quant_matmul(x, packed, scales, biases, bits, group)
    torch.cuda.synchronize()
    assert qmm.launch_count == before + 1
    _check_qmm(y, qmm.quant_matmul_reference(x, packed, scales, biases, bits, group))


@pytest.mark.cuda
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float16])
def test_quant_kernel_reads_half_scales(gen, scale_dtype):
    """MLX snapshots store scales and biases in bf16 or fp16."""
    x, packed, scales, biases = _quantized(gen, 64, 1024, 256, 4, 64, scale_dtype)
    y = qmm.quant_matmul(x.reshape(2, 32, 1024), packed, scales, biases, 4, 64)
    assert y.shape == (2, 32, 256)
    _check_qmm(y.reshape(64, 256), qmm.quant_matmul_reference(x, packed, scales, biases, 4, 64))


@pytest.mark.cuda
def test_quant_kernel_bar_rejects_bf16_rounded_scales(gen):
    """The control: the plain version on bf16-rounded scales and biases
    fails the bar that the kernel passes."""
    x, packed, scales, biases = _quantized(gen, 320, 4096, 1024, 4, 64)
    ref = qmm.quant_matmul_reference(x, packed, scales, biases, 4, 64)
    _check_qmm(qmm.quant_matmul(x, packed, scales, biases, 4, 64), ref)
    with pytest.raises(AssertionError):
        _check_qmm(qmm.quant_matmul_reference(x, packed, scales.bfloat16(), biases.bfloat16(), 4, 64), ref)


@pytest.mark.cuda
def test_quant_kernel_rejects_what_it_does_not_take(gen):
    x, packed, scales, biases = _quantized(gen, 8, 256, 64, 4, 64)
    before = qmm.launch_count
    with pytest.raises(ValueError, match="bfloat16"):
        qmm.quant_matmul(x.float(), packed, scales, biases, 4, 64)
    with pytest.raises(ValueError, match="bits"):
        qmm.quant_matmul(x, packed, scales, biases, 3, 64)
    with pytest.raises(ValueError):
        qmm.quant_matmul(x[:, :200], packed, scales, biases, 4, 64)
    with pytest.raises(ValueError, match="int32"):
        qmm.quant_matmul(x, packed.float(), scales, biases, 4, 64)
    with pytest.raises(ValueError, match="whole"):
        qmm.quant_matmul(x, packed, scales, biases, 4, 4)
    assert qmm.launch_count == before
