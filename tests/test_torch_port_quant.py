"""The port's group-affine quantization and quantized linears against the JAX
package, on the CPU.

Inputs come from a seeded numpy generator and go to both sides. Bars, each
with its reason:
- quantize: the integer codes are the JAX codes, except that at most 0.1 %
  may sit one level off (a round-half tie that the other framework's
  division rounds to the other side); scales and biases within 1e-7
  relative (the same fp32 min/max arithmetic), one fp32 ulp against the
  stacked DiT path (see test_port_quantize_dit_params_matches_jax);
- dequantize: bit-exact on the same words, scales and biases;
- the plain dequantizing matmul in fp32: within 1e-5 of the largest output
  against the JAX XLA path and against the Pallas kernel in interpret mode
  on bf16-exact scales (fp32 sums in another order);
- the quantized DiT forward on tiny_test_config(): 5e-4 relative to the
  output's largest value, the DiT bar of tests/test_torch_port_dit.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_video_tpu.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu.models.ltx import model as jm
from mlx_video_tpu.ops import linear as jlinear
from mlx_video_tpu.ops import quant as jquant
from mlx_video_tpu.ops.quant_matmul import quant_matmul as jax_quant_matmul
from mlx_video_tpu.pipelines.positions import create_position_grid
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.ops import linear as tlinear
from mlx_video_tpu_torch.ops import quant as tquant
from mlx_video_tpu_torch.ops import quant_matmul as tqmm


def _words(packed) -> torch.Tensor:
    """JAX uint32 words -> the port's int32 tensor with the same bits."""
    return torch.from_numpy(np.array(packed).view(np.int32))


def _codes(packed: torch.Tensor, bits: int, in_dim: int) -> np.ndarray:
    """Integer codes of packed words (an affine of scale 1, bias 0 is exact)."""
    ones = torch.ones(packed.shape[0], 1)
    return tquant.dequantize_affine(packed, ones, 0 * ones, bits=bits, dtype=torch.float32).numpy()


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("group", [32, 64, 128])
def test_quantize_and_dequantize_match_jax(rng, bits, group):
    w = rng.normal(size=(48, 256)).astype(np.float32)
    pj, sj, bj = (np.array(a) for a in jquant.quantize_affine(jnp.asarray(w), group, bits))
    pt, st, bt = tquant.quantize_affine(torch.from_numpy(w), group, bits)
    assert pt.dtype == torch.int32 and pt.shape == pj.shape == (48, 256 * bits // 32)
    np.testing.assert_allclose(st.numpy(), sj, rtol=1e-7, atol=0)
    np.testing.assert_allclose(bt.numpy(), bj, rtol=1e-7, atol=0)
    cj, ct = _codes(_words(pj), bits, 256), _codes(pt, bits, 256)
    assert np.abs(cj - ct).max() <= 1 and np.mean(cj != ct) <= 1e-3
    # pack -> unpack -> pack round trip, and the JAX layout bit for bit
    if 32 % bits:
        np.testing.assert_array_equal(
            tquant._pack_bitstream(torch.from_numpy(cj.astype(np.int64)), bits).numpy(), _words(pj).numpy()
        )
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = np.asarray(jquant.dequantize_affine(jnp.asarray(pj), jnp.asarray(sj), jnp.asarray(bj),
                                                  bits=bits, dtype=jdtype), np.float32)
        got = tquant.dequantize_affine(_words(pj), torch.from_numpy(sj), torch.from_numpy(bj), bits=bits, dtype=dtype)
        np.testing.assert_array_equal(got.float().numpy(), ref)
    assert torch.equal(tquant.dequantize_affine(pt, st, bt, in_dim=256), tquant.dequantize_affine(pt, st, bt, bits=bits))


def test_dequantize_needs_bits_or_in_dim():
    p, s, b = tquant.quantize_affine(torch.randn(4, 64), 32, 4)
    with pytest.raises(ValueError, match="bits or in_dim"):
        tquant.dequantize_affine(p, s, b)
    with pytest.raises(ValueError, match="Inconsistent"):
        tquant.dequantize_affine(p, s, b, in_dim=48)


def _quant_linear(rng, k, n, bits, group, bias=True):
    w = rng.normal(size=(n, k)).astype(np.float32) * k**-0.5
    packed, scales, biases = (np.array(a) for a in jquant.quantize_affine(jnp.asarray(w), group, bits))
    params = {"quant_weight": packed, "scales": scales, "biases": biases}
    layer = tlinear.QuantLinear(k, n, bits, group, bias=bias, dtype=torch.float32)
    layer.quant_weight.copy_(_words(packed))
    layer.scales.copy_(torch.from_numpy(scales))
    layer.biases.copy_(torch.from_numpy(biases))
    if bias:
        params["bias"] = rng.normal(size=(n,)).astype(np.float32)
        layer.bias.data.copy_(torch.from_numpy(params["bias"]))
    return params, layer


@pytest.mark.parametrize("bits, group", [(2, 32), (3, 64), (4, 64), (5, 32), (6, 128), (8, 128), (4, 16), (8, 256)])
def test_quant_linear_matches_jax_xla_path(rng, bits, group):
    """2/4/8 bits take K2's plain version on the CPU, 3/5/6 bits dequantize
    then matmul; both against JAX's default (kernel-off) XLA path."""
    params, layer = _quant_linear(rng, 256, 96, bits, group)
    x = rng.normal(size=(2, 5, 256)).astype(np.float32)
    before = tqmm.launch_count
    got = tlinear.linear(layer, torch.from_numpy(x)).numpy()
    assert tqmm.launch_count == before  # a CPU tensor never launches the kernel
    ref = np.asarray(jlinear.linear(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    assert got.shape == ref.shape == (2, 5, 96)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("bits, group", [(2, 16), (3, 32), (4, 16), (4, 128), (5, 64), (6, 32), (8, 256)])
def test_linear_routes_by_bits_alone(rng, monkeypatch, bits, group):
    """2/4/8 bits go to K2 whatever the group size; 3/5/6 bits dequantize
    then matmul."""
    calls = []
    monkeypatch.setattr(tlinear, "quant_matmul", lambda *a: calls.append(a[4:]) or tqmm.quant_matmul(*a))
    _, layer = _quant_linear(rng, 256, 32, bits, group, bias=False)
    tlinear.linear(layer, torch.zeros(3, 256))
    assert calls == ([(bits, group)] if bits in (2, 4, 8) else [])


@pytest.mark.parametrize("bits, group", [(3, 64), (4, 64), (8, 128)])
def test_dequantize_linear_params_matches_jax(rng, bits, group):
    """QuantLinear -> dense Linear, bit for bit JAX's (in, out) weight
    transposed; the bias tensor is shared, not copied."""
    params, layer = _quant_linear(rng, 256, 96, bits, group)
    ref = jquant.dequantize_linear_params(jax.tree.map(jnp.asarray, params), bits, dtype=jnp.float32)
    dense = tquant.dequantize_linear_params(layer, dtype=torch.float32)
    assert isinstance(dense, tlinear.Linear) and dense.bias is layer.bias
    np.testing.assert_array_equal(dense.weight.numpy(), np.asarray(ref["weight"]).T)


def _pallas(x, params, bits, group):
    return np.asarray(jax_quant_matmul(jnp.asarray(x), jnp.asarray(params["quant_weight"]), jnp.asarray(params["scales"]),
                                       jnp.asarray(params["biases"]), bits, group, interpret=True))


@pytest.mark.parametrize("bits, group", [(4, 64), (8, 128), (2, 32)])
def test_plain_version_matches_pallas_kernel_on_bf16_scales(rng, bits, group):
    params, _ = _quant_linear(rng, 256, 128, bits, group, bias=False)
    for leaf in ("scales", "biases"):  # bf16-exact: the kernel's bf16 rounding is then a no-op
        params[leaf] = params[leaf].astype(jnp.bfloat16).astype(np.float32)
    x = rng.normal(size=(24, 256)).astype(np.float32)
    ref = _pallas(x, params, bits, group)
    got = tqmm.quant_matmul(torch.from_numpy(x), _words(params["quant_weight"]), torch.from_numpy(params["scales"]),
                            torch.from_numpy(params["biases"]), bits, group).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_pallas_bf16_scale_rounding_gap_is_pinned(rng):
    """The Pallas wrapper rounds fp32 scales and biases to bf16
    (quant_matmul.py:141-143); the port, like JAX's default XLA path, keeps
    them fp32. The gap is exactly that rounding: the Pallas result equals the
    plain version on bf16-rounded scales, and sits 1e-4..1e-1 of max |y| away
    from the plain version on the fp32 ones."""
    params, _ = _quant_linear(rng, 256, 128, 4, 64, bias=False)
    x = rng.normal(size=(24, 256)).astype(np.float32)
    pallas = _pallas(x, params, 4, 64)
    words = _words(params["quant_weight"])

    def plain(sc, bi):
        return tqmm.quant_matmul_reference(torch.from_numpy(x), words, torch.from_numpy(sc),
                                           torch.from_numpy(bi), 4, 64).numpy()

    exact = plain(params["scales"], params["biases"])
    rounded = plain(*(params[k].astype(jnp.bfloat16).astype(np.float32) for k in ("scales", "biases")))
    peak = np.abs(exact).max()
    assert np.abs(pallas - rounded).max() <= 1e-5 * peak
    assert 1e-4 * peak <= np.abs(pallas - exact).max() <= 1e-1 * peak


def test_bf16_rounded_scales_fail_the_kernel_bar(rng):
    """The control for the kernel's bar on the card (relative L2 <= 1e-3
    against the plain version, tests/test_torch_port_kernels.py): rounding
    fp32 scales and biases to bf16 before the affine, as the Pallas kernel
    does, moves a bf16 product by more than that bar."""
    params, _ = _quant_linear(rng, 1024, 256, 4, 64, bias=False)
    x = torch.from_numpy(rng.normal(size=(64, 1024)).astype(np.float32)).to(torch.bfloat16)
    words = _words(params["quant_weight"])
    sc, bi = (torch.from_numpy(params[k]) for k in ("scales", "biases"))
    exact = tqmm.quant_matmul_reference(x, words, sc, bi, 4, 64).float()
    rounded = tqmm.quant_matmul_reference(x, words, sc.bfloat16(), bi.bfloat16(), 4, 64).float()
    assert ((rounded - exact).norm() / exact.norm()).item() > 1e-3


def test_quant_matmul_rejects_bad_operands():
    x = torch.randn(3, 128)
    p, s, b = tquant.quantize_affine(torch.randn(16, 128), 64, 4)
    with pytest.raises(ValueError, match="bits"):
        tqmm.quant_matmul(x, p, s, b, 3, 64)
    with pytest.raises(ValueError, match="group_size 4 must hold whole 8-value words"):
        tqmm.quant_matmul(x, p, s, b, 4, 4)
    with pytest.raises(ValueError, match="packed"):
        tqmm.quant_matmul(x[:, :64], p, s, b, 4, 64)
    with pytest.raises(ValueError, match="int32"):
        tqmm.quant_matmul(x, p.float(), s, b, 4, 64)
    with pytest.raises(ValueError):
        tqmm.quant_matmul(x.to("meta"), p, s, b, 4, 64)


def _port(cfg):
    """The same configuration as the port's own config class."""
    return tconfig.LTXModelConfig.from_dict(cfg.to_dict())


@pytest.fixture(scope="module")
def quantized_dit():
    """JAX init (seeded values) -> JAX quantize_dit_params -> bridge."""
    cfg = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)
    rng = np.random.default_rng(4)
    shapes = jax.eval_shape(lambda: jm.init_ltx_params(jax.random.key(0), cfg, dtype=jnp.float32))
    dense = jax.tree.map(lambda s: (rng.normal(size=s.shape) * 0.1).astype(np.float32), shapes)
    qparams = jquant.quantize_dit_params(jax.tree.map(jnp.asarray, dense), group_size=64, bits=4)
    model = tm.LTXModel(_port(cfg), device="cpu", dtype=torch.float32)
    jax_bridge.load_jax_params(model, jax.tree.map(np.asarray, qparams))
    return cfg, dense, qparams, model


def test_quantized_dit_matches_jax(quantized_dit):
    cfg, _, qparams, model = quantized_dit
    n_quant = sum(isinstance(m, tlinear.QuantLinear) for m in model.modules())
    assert n_quant == 10 * cfg.num_layers
    rng = np.random.default_rng(5)
    b, f, h, w = 1, 2, 4, 4
    tokens = rng.normal(size=(b, f * h * w, cfg.in_channels)).astype(np.float32)
    context = rng.normal(size=(b, 6, cfg.caption_channels)).astype(np.float32)
    ts = np.full((b, 1), 0.6, np.float32)
    pos = create_position_grid(b, f, h, w)
    ref, _ = jm.ltx_apply(qparams, cfg, video=jm.Modality(
        latent=jnp.asarray(tokens), timesteps=jnp.asarray(ts), context=jnp.asarray(context),
        positions=jnp.asarray(pos),
    ))
    got, _ = tm.ltx_apply(model, _port(cfg), tm.Modality(
        latent=torch.from_numpy(tokens), timesteps=torch.from_numpy(ts), context=torch.from_numpy(context),
        positions=torch.from_numpy(pos),
    ))
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() <= 5e-4


def test_bridge_round_trip_of_quantized_tree_is_bit_exact(quantized_dit):
    _, _, qparams, model = quantized_dit
    back = jax_bridge.module_to_jax_tree(model)
    ref = jax.tree.map(np.asarray, qparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for x, y in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_port_quantize_dit_params_matches_jax(quantized_dit):
    """The port's in-place quantize_dit_params on the bridged dense model
    gives JAX's leaves (codes to the quantize bar, scales to 1e-7)."""
    cfg, dense, qparams, _ = quantized_dit
    model = tm.LTXModel(cfg, device="cpu", dtype=torch.float32)
    jax_bridge.load_jax_params(model, dense)
    dense_ff = model.blocks[0].ff.proj_in
    assert tquant.quantize_dit_params(model, group_size=64, bits=4) is model
    assert isinstance(model.blocks[0].ff.proj_in, tlinear.QuantLinear)
    assert model.blocks[0].ff.proj_in.bias is dense_ff.bias  # shared, not copied
    assert isinstance(model.video.patchify_proj, tlinear.Linear)  # outside the blocks
    assert isinstance(model.blocks[0].attn1.q_norm, tm.RMSNormWeight)
    ours = jax_bridge.module_to_jax_tree(model)
    ref = jax.tree.map(np.asarray, qparams)
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        got = ours
        for k in path:
            got = got[k.key]
        name = path[-1].key
        if name == "quant_weight":
            in_dim = leaf.shape[-1] * 8
            for layer in range(leaf.shape[0]):
                cj = _codes(_words(leaf[layer]), 4, in_dim)
                ct = _codes(_words(got[layer]), 4, in_dim)
                assert np.abs(cj - ct).max() <= 1 and np.mean(cj != ct) <= 1e-3, path
        elif name in ("scales", "biases"):
            # one fp32 ulp: over the stacked layers JAX's quantize_linear_params
            # runs under lax.map, where XLA multiplies by 1/levels; its
            # single-matrix quantize_affine, and the port, divide by levels
            np.testing.assert_allclose(got, leaf, rtol=np.finfo(np.float32).eps, atol=0)
        else:
            np.testing.assert_array_equal(got, leaf)


def test_quantize_dit_params_rejects_unknown_scope(quantized_dit):
    cfg = quantized_dit[0]
    with pytest.raises(ValueError, match="scope"):
        tquant.quantize_dit_params(tm.LTXModel(cfg, device="meta"), scope="blocks")
