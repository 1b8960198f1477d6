"""The port's flash attention (mlx_video_tpu_torch/ops) against the JAX package.

On the CPU the port's wrapper computes its plain fp32 version; it is held
against the Pallas kernel ``_flash_attention_impl`` run in interpret mode,
as tests/test_flash_attention.py runs it. Inputs are fp32 from a seeded
numpy generator; the bar is 2e-5 absolute (fp32 sums over a few hundred
keys in another order). The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_port_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_video_tpu.ops.flash_attention import _flash_attention_impl
from mlx_video_tpu_torch.ops import attention as port_attention
from mlx_video_tpu_torch.ops import flash_attention as port_fa

ATOL = 2e-5


def _qkv(s, h=2, d=128, b=1, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, s, h, d)) * scale).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("s", [256, 320])
def test_single_pass_body_matches_port(s):
    q, k, v = _qkv(s)
    ref = np.asarray(_flash_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=128**-0.5, interpret=True
    ))
    got = port_fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("s", [300, 640])
def test_online_body_with_lse_matches_port(s):
    q, k, v = _qkv(s, seed=1)
    b, _, h, _ = q.shape
    ref_o, ref_lse = _flash_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=128**-0.5,
        interpret=True, save_lse=True,
    )
    # JAX keeps (B*H, S_pad, 128) lane-replicated; the port one value per row.
    ref_lse = np.asarray(ref_lse)[:, :s, 0].reshape(b, h, s)
    got_o, got_lse = port_fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), return_lse=True
    )
    assert got_lse.shape == (b, h, s) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), ref_lse, atol=ATOL, rtol=0)


def test_single_pass_clamp_gap_is_pinned():
    """Past +/-80 scaled logits the Pallas single-pass body saturates; the
    port stays exact and matches jax.nn.dot_product_attention within 1e-5."""
    q, k, v = _qkv(256, seed=2)
    q, k = q * 10.0, k * 10.0  # scaled logits with std ~100
    exact = np.asarray(jax.nn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=128**-0.5
    ))
    single = np.asarray(_flash_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=128**-0.5, interpret=True
    ))
    got = port_fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert np.abs(single - exact).max() > 0.1  # the clamp's gap
    np.testing.assert_allclose(got.numpy(), exact, atol=1e-5, rtol=0)


def test_cpu_wrapper_takes_plain_version_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _qkv(130, h=3, d=64, seed=3))
    before = port_fa.launch_count
    out, lse = port_fa.flash_attention(q, k, v, return_lse=True)
    ref, ref_lse = port_fa.flash_attention_reference(q, k, v, 64**-0.5, return_lse=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    routed = port_attention.sdpa(q, k, v)
    assert torch.equal(routed, ref)
    assert port_fa.launch_count == before


def test_cross_attention_with_bias_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 96, 2, 32)).astype(np.float32)
    k = rng.normal(size=(2, 10, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, 10, 2, 32)).astype(np.float32)
    mask = (rng.uniform(size=(2, 10)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    bias = ((mask - 1.0) * 1e9).reshape(2, 1, 1, 10)
    ref = np.asarray(jax.nn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias)
    ))
    got = port_attention.sdpa(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), bias=torch.from_numpy(bias)
    )
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize(
    "q, k, match",
    [
        (torch.zeros(1, 64, 2, 128), torch.zeros(1, 64, 2, 128), "bfloat16"),
        (_bf16((1, 64, 2, 32)), _bf16((1, 64, 2, 32)), "head dim"),
        (_bf16((1, 64, 2, 128)), _bf16((1, 32, 2, 128)), r"\(B, S, H, D\)"),
        (_bf16((1, 128, 2, 64)), _bf16((1, 128, 64, 2)).transpose(2, 3), "contiguous"),
    ],
)
def test_kernel_operand_checks_reject(q, k, match):
    with pytest.raises(ValueError, match=match):
        port_fa._check_operands(q, k, k)


def test_wrapper_rejects_other_devices():
    q = torch.empty(1, 8, 1, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        port_fa.flash_attention(q, q, q)
