"""The port's flash backward (K3's plain version and the autograd Function on
the CPU) against the JAX package's.

The JAX side runs its Pallas backward kernels in interpret mode, forced on
with ``_FORCE_FLASH_BWD = True`` on the module object as
tests/test_flash_attention.py does, and its XLA attention gradients. Inputs
are fp32 from a seeded numpy generator. Bars: 2e-4 absolute against the
Pallas backward and against XLA (fp32 sums in another order; the bar of the
JAX package's own kernel test); 1e-5 against torch autograd through the plain
forward (the same fp32 math, other association). The kernel itself is tested
on the card in tests/test_torch_port_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_video_tpu.ops.flash_attention as jfa
from mlx_video_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn gradients off process-wide when imported."""
    with torch.enable_grad():
        yield


def _inputs(rng, s, h=2, d=128, scale_qk=1.0):
    base = lambda: rng.normal(size=(1, s, h, d)).astype(np.float32)  # noqa: E731
    q, k = base() * scale_qk, base() * scale_qk
    return q, k, base(), base()


def _jax_grads(q, k, v, co, pallas: bool):
    scale = q.shape[-1] ** -0.5

    def loss(q, k, v):
        if pallas:
            out = jfa.flash_attention(q, k, v, scale=scale, interpret=True)
        else:
            out = jax.nn.dot_product_attention(q, k, v, scale=scale)
        return jnp.sum(out * co)

    orig = jfa._FORCE_FLASH_BWD
    jfa._FORCE_FLASH_BWD = True
    try:
        grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    finally:
        jfa._FORCE_FLASH_BWD = orig
    return [np.asarray(g) for g in grads]


def _port_grads(q, k, v, co):
    scale = q.shape[-1] ** -0.5
    tq, tk, tv, tco = (torch.from_numpy(x) for x in (q, k, v, co))
    out, lse = tfa.flash_attention_reference(tq, tk, tv, scale, return_lse=True)
    return [g.numpy() for g in tfa.flash_attention_bwd_reference(tq, tk, tv, out, lse, tco, scale)]


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas_interpret", "xla"])
@pytest.mark.parametrize("s", [256, 384, 500])  # single block, multi, ragged
def test_bwd_reference_matches_jax(rng, s, pallas):
    q, k, v, co = _inputs(rng, s)
    for name, got, ref in zip("qkv", _port_grads(q, k, v, co), _jax_grads(q, k, v, co, pallas)):
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0, err_msg=f"d{name} at s={s}")


def test_bwd_reference_head_dim_64_matches_xla(rng):
    q, k, v, co = _inputs(rng, 200, h=3, d=64)
    for got, ref in zip(_port_grads(q, k, v, co), _jax_grads(q, k, v, co, pallas=False)):
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


def test_bwd_reference_saturated_logits_finite(rng):
    """Logits past +/-80 (the Pallas single-pass clamp): finite gradients that
    match XLA's."""
    base = rng.normal(size=(1, 256, 1, 128)).astype(np.float32) * 12.0
    q, k = base, base.copy()
    v, co = (rng.normal(size=base.shape).astype(np.float32) for _ in range(2))
    assert (np.einsum("bshd,bthd->bhst", q, k) * 128**-0.5).max() > 80.0
    got = _port_grads(q, k, v, co)
    assert all(np.isfinite(g).all() for g in got)
    for g, ref in zip(got, _jax_grads(q, k, v, co, pallas=False)):
        np.testing.assert_allclose(g, ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("s, d", [(100, 128), (77, 64)])
def test_function_gradients_match_autograd_of_plain_forward(rng, s, d):
    q, k, v, co = _inputs(rng, s, d=d)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = (tfa.launch_count, tfa.bwd_launch_count)
    got = torch.autograd.grad(tfa.flash_attention(*leaves), leaves, torch.from_numpy(co))
    assert (tfa.launch_count, tfa.bwd_launch_count) == before  # the CPU never launches a kernel
    ref = torch.autograd.grad(tfa.flash_attention_reference(*leaves, d**-0.5), leaves, torch.from_numpy(co))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5, rtol=0)


def test_no_grad_forward_takes_no_residuals(rng):
    q, k, v, _ = _inputs(rng, 64)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        out = tfa.flash_attention(*leaves)
    assert out.grad_fn is None
    assert tfa.flash_attention(*leaves).grad_fn is not None
