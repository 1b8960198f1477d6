"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs where JAX is not installed, without the repo's
conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_port_kernels.py

Bars: max |d o| <= 2e-2 (the bf16 output rounds to one ulp, 1.6e-2 at
|o| ~ 2-4) and max |d lse| <= 1e-3 (fp32 sums in another order).
"""

import pytest
import torch

from mlx_video_tpu_torch.ops import flash_attention as fa


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
