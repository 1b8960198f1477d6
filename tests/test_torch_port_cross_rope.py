"""K4 (text cross-attention) and K5 (flash attention with fused split RoPE)
of the port against the JAX package, on the CPU, and their routes.

On a CPU tensor the port's wrappers compute their plain versions; they are
held against the Pallas kernels ``flash_cross_attention`` and
``flash_attention_split_rope`` run in interpret mode, as
tests/test_flash_attention.py runs them, and their gradients against the JAX
custom VJPs. Inputs are fp32 from seeded numpy generators. Bars: outputs
5e-5 absolute (fp32 sums over a few hundred keys in another order; the bar
of tests/test_flash_attention.py for the cross kernel), gradients 1e-4
relative L2 (the same sums, twice). The CUDA kernels are held against the
plain versions on the card by tests/test_torch_port_kernels.py.

The route tests run a tiny DiT (2 heads of 128, 288 tokens, a caption mask)
with MLX_VIDEO_TPU_CROSS_KERNEL and MLX_VIDEO_TPU_FUSED_ROPE on and off,
against JAX ``ltx_apply`` with both switches on (the Pallas kernels patched
to interpret mode inside the test only), with spies that show which route
the port took. Bar: 5e-4 relative to the output's largest value, the DiT
parity bar of tests/test_torch_port_dit.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_video_tpu.ops.flash_attention as jfa
from mlx_video_tpu.config import LTXModelConfig, LTXModelType, LTXRopeType
from mlx_video_tpu.models.ltx import model as jm
from mlx_video_tpu.models.ltx import rope as jrope
from mlx_video_tpu.ops import attention as jattention
from mlx_video_tpu.pipelines.positions import create_position_grid
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.models.ltx import rope as trope
from mlx_video_tpu_torch.ops import attention as tattention
from mlx_video_tpu_torch.ops import cross_attention as tca
from mlx_video_tpu_torch.ops import flash_attention as tfa

ATOL = 5e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _grad_on():
    with torch.enable_grad():
        yield


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _bias_rows(b, skv, real):
    """(mask - 1) * 1e9 caption-mask bias rows; row i keeps real[i] keys."""
    mask = np.zeros((b, skv), np.float32)
    for i, n in enumerate(real):
        mask[i, :n] = 1.0
    return (mask - 1.0) * 1e9


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


CROSS_CASES = {
    "ragged_skv": (2, 300, 77, None),
    "trainer_mask": (1, 256, 128, (40,)),
    "all_masked_row": (2, 256, 128, (128, 0)),
    "two_masks": (2, 260, 100, (30, 90)),
}


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_cross_plain_version_matches_pallas(case):
    b, sq, skv, real = CROSS_CASES[case]
    rng = np.random.default_rng(1)
    q, k, v = _normal(rng, b, sq, 2, 128), _normal(rng, b, skv, 2, 128), _normal(rng, b, skv, 2, 128)
    bias = None if real is None else _bias_rows(b, skv, real)
    ref = jfa.flash_cross_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=None if bias is None else jnp.asarray(bias),
        block_q=128, interpret=True,
    )
    got = tca.flash_cross_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                    bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    if real is not None and 0 in real:  # the -1e9 bias collapses in fp32: uniform over the keys
        row = real.index(0)
        np.testing.assert_allclose(got[row].numpy(), np.broadcast_to(v[row].mean(0), got[row].shape), atol=ATOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_cross_gradients_match_the_jax_vjp(with_bias):
    rng = np.random.default_rng(2)
    b, sq, skv = 2, 256, 100
    q, k, v = _normal(rng, b, sq, 2, 128), _normal(rng, b, skv, 2, 128), _normal(rng, b, skv, 2, 128)
    bias = _bias_rows(b, skv, (60, 100)) if with_bias else None
    co = _normal(rng, b, sq, 2, 128)

    def loss(q, k, v):
        out = jfa.flash_cross_attention(q, k, v, bias=None if bias is None else jnp.asarray(bias),
                                        block_q=128, interpret=True)
        return jnp.sum(out * jnp.asarray(co))

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tca.flash_cross_attention(*leaves, bias=None if bias is None else torch.from_numpy(bias))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(co))
    for g, r in zip(got, ref):
        assert _rel_l2(g.numpy(), r) <= GRAD_RTOL


def _rope_inputs(rng, b, f, h, w, heads=2, d=128):
    s = f * h * w
    positions = create_position_grid(b, f, h, w)
    cos, sin = trope.precompute_freqs_cis(
        torch.from_numpy(positions), dim=heads * d, num_attention_heads=heads,
        rope_type=tconfig.LTXRopeType.SPLIT, max_pos=[20, 2048, 2048], use_middle_indices_grid=True,
    )
    return [_normal(rng, b, s, heads, d) for _ in range(3)], cos, sin


@pytest.mark.parametrize("b, f, h, w", [(1, 2, 12, 12), (2, 3, 10, 10)])
def test_rope_plain_version_matches_pallas(b, f, h, w):
    (q, k, v), cos, sin = _rope_inputs(np.random.default_rng(3), b, f, h, w)
    ref = jfa.flash_attention_split_rope(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()),
        block_q=128, block_k=128, interpret=True,
    )
    got = tfa.flash_attention_split_rope(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_rope_gradients_match_the_jax_vjp():
    rng = np.random.default_rng(4)
    (q, k, v), cos, sin = _rope_inputs(rng, 1, 2, 12, 12)
    co = _normal(rng, *q.shape)
    jcos, jsin = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())

    def loss(q, k, v):
        out = jfa.flash_attention_split_rope(q, k, v, jcos, jsin, block_q=128, block_k=128, interpret=True)
        return jnp.sum(out * jnp.asarray(co))

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(tfa.flash_attention_split_rope(*leaves, cos, sin), leaves, torch.from_numpy(co))
    for g, r in zip(got, ref):
        assert _rel_l2(g.numpy(), r) <= GRAD_RTOL


def test_rope_refuses_table_gradients():
    (q, k, v), cos, sin = _rope_inputs(np.random.default_rng(5), 1, 1, 4, 4)
    with pytest.raises(ValueError, match="gradient"):
        tfa.flash_attention_split_rope(*(torch.from_numpy(x) for x in (q, k, v)), cos.requires_grad_(), sin)


def test_rotation_is_the_dit_rotation_and_its_transpose_inverts_it():
    (q, _, _), cos, sin = _rope_inputs(np.random.default_rng(6), 2, 2, 4, 4)
    x = torch.from_numpy(q)
    rotated = tfa.rotate_split(x, cos, sin)
    b, s, h, d = x.shape
    assert torch.equal(rotated.reshape(b, s, h * d), trope.apply_split_rotary_emb(x.reshape(b, s, h * d), cos, sin))
    jref = jrope.apply_rotary_emb(jnp.asarray(q.reshape(b, s, h * d)), (jnp.asarray(cos.numpy()),
                                  jnp.asarray(sin.numpy())), LTXRopeType.SPLIT)
    np.testing.assert_allclose(rotated.reshape(b, s, h * d).numpy(), np.asarray(jref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tfa.rotate_split(rotated, cos, sin, inverse=True).numpy(), q, atol=1e-5, rtol=0)


@pytest.mark.parametrize("b, d", [(1, 128), (2, 64)])
def test_rotation_pass_is_the_pallas_kernels_rotation(b, d):
    """K5's rotation pass (``rope_rotate``; on the CPU the plain rotation)
    against the rotation the Pallas kernel applies in fp32
    (``_apply_split_rope_f32``), one (batch, head) at a time, on q and k in
    bf16 as the kernel takes them; at B = 2 the tables are concatenated as
    batched CFG concatenates them."""
    (q, k, _), cos, sin = _rope_inputs(np.random.default_rng(7), 1, 2, 4, 4, d=d)
    if b == 2:
        cos, sin = torch.cat([cos, cos]), torch.cat([sin, sin])
        q, k = np.concatenate([q, k]), np.concatenate([k, q])
    x = [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k)]
    got = tfa.rope_rotate(*x, cos, sin)
    for g, t in zip(got, x):
        assert g.is_contiguous() and torch.equal(g, tfa.rotate_split(t, cos, sin))
        for i in range(b):
            for j in range(t.shape[2]):
                ref = jfa._apply_split_rope_f32(jnp.asarray(t[i, :, j].float().numpy()),
                                                jnp.asarray(cos[i, j].numpy()), jnp.asarray(sin[i, j].numpy()))
                np.testing.assert_array_equal(g[i, :, j].float().numpy(),
                                              np.asarray(ref.astype(jnp.bfloat16).astype(jnp.float32)))


def test_eligibility_keeps_only_the_defining_conditions(monkeypatch):
    """Tiny heads and short sequences route too; shapes that do not define
    the functions do not."""
    monkeypatch.setattr(tattention, "_USE_CROSS_KERNEL", True)
    monkeypatch.setattr(tattention, "_USE_FUSED_ROPE", True)
    q, k = torch.zeros(2, 10, 4, 32), torch.zeros(2, 3, 4, 32)
    assert tattention._cross_eligible(q, k, None)
    assert tattention._cross_eligible(q, k, torch.zeros(2, 1, 1, 3))
    assert not tattention._cross_eligible(q, q, None)
    assert not tattention._cross_eligible(q, k, torch.zeros(2, 4, 10, 3))
    flat = torch.zeros(2, 10, 4 * 32)
    tables = (torch.zeros(2, 4, 10, 16), torch.zeros(2, 4, 10, 16))
    assert tattention.fused_split_rope_eligible(flat, 4, tables)
    assert not tattention.fused_split_rope_eligible(flat, 4, (torch.zeros(1, 4, 10, 16),) * 2)
    assert not tattention.fused_split_rope_eligible(flat, 4, None)
    monkeypatch.setattr(tattention, "_USE_CROSS_KERNEL", False)
    monkeypatch.setattr(tattention, "_USE_FUSED_ROPE", False)
    assert not tattention._cross_eligible(q, k, None)
    assert not tattention.fused_split_rope_eligible(flat, 4, tables)


def test_switches_are_read_from_the_jax_environment_variables():
    import subprocess
    import sys

    code = ("from mlx_video_tpu_torch.ops import attention as a; "
            "print(a._USE_CROSS_KERNEL, a._USE_FUSED_ROPE)")
    for env, want in (({}, "False False"), ({"MLX_VIDEO_TPU_CROSS_KERNEL": "1", "MLX_VIDEO_TPU_FUSED_ROPE": "1"},
                                            "True True")):
        import os

        full = {k: v for k, v in os.environ.items() if not k.startswith("MLX_VIDEO_TPU_")}
        out = subprocess.run([sys.executable, "-c", code], env={**full, **env}, capture_output=True, text=True,
                             check=True).stdout.split()
        assert " ".join(out) == want


ROUTE_CFG = LTXModelConfig(
    model_type=LTXModelType.VideoOnly, num_attention_heads=2, attention_head_dim=128, in_channels=16,
    out_channels=16, num_layers=2, cross_attention_dim=256, caption_channels=48, rope_type=LTXRopeType.SPLIT,
)


@pytest.fixture(scope="module")
def route_inputs():
    rng = np.random.default_rng(7)
    params = jm.init_ltx_params(jax.random.key(0), ROUTE_CFG, dtype=jnp.float32)
    b, f, h, w = 2, 2, 12, 12  # 288 tokens: the Pallas routes need >= 256
    mask = np.ones((b, 8), np.int32)
    mask[1, 5:] = 0
    inputs = dict(
        latent=_normal(rng, b, f * h * w, 16), timesteps=np.full((b, f * h * w), 0.5, np.float32),
        context=_normal(rng, b, 8, 48), positions=create_position_grid(b, f, h, w), context_mask=mask,
    )
    video = jm.Modality(**{k: jnp.asarray(v) for k, v in inputs.items()})
    orig_rope, orig_cross = jfa.flash_attention_split_rope, jfa.flash_cross_attention
    calls = {"rope": 0, "cross": 0}

    def rope_spy(*a, **kw):
        calls["rope"] += 1
        return orig_rope(*a, **kw, interpret=True)

    def cross_spy(*a, **kw):
        calls["cross"] += 1
        return orig_cross(*a, **kw, interpret=True)

    try:
        jfa.flash_attention_split_rope, jfa.flash_cross_attention = rope_spy, cross_spy
        jattention.use_pallas_flash(True)
        jattention.use_fused_rope(True)
        jattention.use_cross_kernel(True)
        ref, _ = jm.ltx_apply(params, ROUTE_CFG, video=video)
    finally:
        jattention.use_pallas_flash(None)
        jattention.use_fused_rope(False)
        jattention.use_cross_kernel(False)
        jfa.flash_attention_split_rope, jfa.flash_cross_attention = orig_rope, orig_cross
    assert calls == {"rope": 1, "cross": 1}, calls  # both Pallas routes, traced once in the scanned block
    model = tm.LTXModel(tconfig.LTXModelConfig.from_dict(ROUTE_CFG.to_dict()), device="cpu", dtype=torch.float32)
    jax_bridge.load_jax_params(model, jax.tree.map(np.asarray, params))
    return model, inputs, np.asarray(ref)


def _port_forward(model, inputs, monkeypatch, on: bool):
    monkeypatch.setattr(tattention, "_USE_CROSS_KERNEL", on)
    monkeypatch.setattr(tattention, "_USE_FUSED_ROPE", on)
    calls = {"rope": 0, "cross": 0, "flash": 0}
    for name, key in (("flash_attention_split_rope", "rope"), ("flash_cross_attention", "cross"),
                      ("flash_attention", "flash")):
        orig = getattr(tattention, name)

        def spy(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(tattention, name, spy)
    video = tm.Modality(**{k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()})
    with torch.no_grad():
        out = tm.ltx_apply(model, tconfig.LTXModelConfig.from_dict(ROUTE_CFG.to_dict()), video)
    return out.numpy(), calls


@pytest.mark.parametrize("on", [True, False])
def test_dit_routes_match_jax_with_both_kernels_on(route_inputs, monkeypatch, on):
    model, inputs, ref = route_inputs
    got, calls = _port_forward(model, inputs, monkeypatch, on)
    want = {"rope": 2, "cross": 2, "flash": 0} if on else {"rope": 0, "cross": 0, "flash": 2}
    assert calls == want
    assert np.abs(got - ref).max() <= 5e-4 * np.abs(ref).max()


def test_dit_routes_on_and_off_are_the_same_on_the_cpu(route_inputs, monkeypatch):
    """The plain versions behind the routes repeat the unrouted arithmetic:
    the rotation is the DiT's, the cross-attention plain_attention's."""
    model, inputs, _ = route_inputs
    on, _ = _port_forward(model, inputs, monkeypatch, True)
    off, _ = _port_forward(model, inputs, monkeypatch, False)
    np.testing.assert_array_equal(on, off)
