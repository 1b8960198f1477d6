"""The port's LoRA (lora.py, the LoRA branch of ops/linear.py and the bridge's
LoRA leaves) against the JAX package's, on tiny_test_config.

Bars: names, shapes and scales equal; the LoRA linear within 1e-6 of the
output's scale (both fp32 with full-precision products: only the summation
order differs); the bridge and the adapter files bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_video_tpu import lora as jlora
from mlx_video_tpu.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu.models.ltx import model as jm
from mlx_video_tpu.ops import linear as jlinear
from mlx_video_tpu.ops import quant as jquant
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch import lora as tlora
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.ops import linear as tlinear

CFG = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)
TCFG = tconfig.LTXModelConfig.from_dict(CFG.to_dict())
TARGETS = [None, ("attn1.to_q", "ff.proj_out"), ("to_k",)]


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn gradients off process-wide when imported."""
    with torch.enable_grad():
        yield


def _lora_leaves(tree, path=()):
    """{path: leaf} of the LoRA leaves of a (JAX-layout) tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_lora_leaves(v, path + (k,)))
        elif k.startswith("lora_"):
            out[path + (k,)] = np.asarray(v)
    return out


def _jax_injected(targets, rank=4, alpha=8.0):
    params = jm.init_ltx_params(jax.random.key(0), CFG, dtype=jnp.float32)
    return jlora.inject_lora(params, CFG, jlora.LoRAConfig(rank=rank, alpha=alpha, target_modules=targets),
                             jax.random.key(1))


def _with_random_factors(tree, seed=0):
    """The tree with every lora_A / lora_B leaf drawn anew (B non-zero)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else (rng.normal(size=np.shape(v)).astype(np.float32) * 0.1 if k in ("lora_A", "lora_B")
                      else np.asarray(v))
                for k, v in node.items()}

    return walk(tree)


@pytest.mark.parametrize("targets", TARGETS)
def test_inject_lora_matches_jax_names_shapes_and_scales(targets):
    ref = _lora_leaves(_jax_injected(targets))
    model = tm.init_ltx_params(TCFG, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    tlora.inject_lora(model, TCFG, tlora.LoRAConfig(rank=4, alpha=8.0, target_modules=targets),
                      torch.Generator().manual_seed(1))
    got = _lora_leaves(jax_bridge.module_to_jax_tree(model))
    assert sorted(got) == sorted(ref) and ref
    for path, leaf in ref.items():
        assert got[path].shape == leaf.shape and got[path].dtype == leaf.dtype == np.float32, path
        if path[-1] == "lora_B":
            assert not got[path].any(), path
        elif path[-1] == "lora_scale":
            np.testing.assert_array_equal(got[path], leaf)
        else:  # A ~ N(0, 0.01)
            assert 0.005 < got[path].std() < 0.02, path
    mask = tlora.lora_mask(model)
    assert {n for n, m in mask.items() if m} == {n for n, _ in model.named_parameters() if ".lora_" in n}


def test_inject_lora_replaces_existing_factors():
    model = tm.init_ltx_params(TCFG, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    tlora.inject_lora(model, TCFG, tlora.LoRAConfig(rank=4), torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.blocks[0].attn1.to_q.lora_B.fill_(1.0)
    tlora.inject_lora(model, TCFG, tlora.LoRAConfig(rank=4), torch.Generator().manual_seed(1))
    assert not model.blocks[0].attn1.to_q.lora_B.any()
    assert sum(".lora_A" in n for n, _ in model.named_parameters()) == 10 * TCFG.num_layers


def _linear_params(rng, quantized: bool):
    params = {
        "weight": rng.normal(size=(64, 96)).astype(np.float32) * 0.1,
        "bias": rng.normal(size=(96,)).astype(np.float32),
        "lora_A": rng.normal(size=(4, 64)).astype(np.float32) * 0.1,
        "lora_B": rng.normal(size=(96, 4)).astype(np.float32) * 0.1,
        "lora_scale": np.float32(2.0),
    }
    if quantized:
        w = params.pop("weight")
        qw, sc, bi = jquant.quantize_affine(jnp.asarray(w.T), group_size=32, bits=4)
        params.update(quant_weight=np.asarray(qw), scales=np.asarray(sc), biases=np.asarray(bi))
    return params


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "q4"])
def test_lora_linear_matches_jax(rng, quantized):
    params = _linear_params(rng, quantized)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    ref = np.asarray(jlinear.linear(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    layer = tlinear.QuantLinear(64, 96, 4, 32) if quantized else tlinear.Linear(64, 96, dtype=torch.float32)
    jax_bridge.load_jax_params(layer, params)
    got = tlinear.linear(layer, torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "q4"])
def test_lora_delta_gradients_match_autograd(rng, quantized):
    """Gradients of the LoRA linear in x, A and B against JAX autograd of
    the same layer (1e-5: fp32 both sides, the sums in another order)."""
    params = _linear_params(rng, quantized)
    x = rng.normal(size=(3, 7, 64)).astype(np.float32)
    g = rng.normal(size=(3, 7, 96)).astype(np.float32)
    tree = jax.tree.map(jnp.asarray, params)

    def f(xx, a, b):
        return jlinear.linear({**tree, "lora_A": a, "lora_B": b}, xx)

    _, vjp = jax.vjp(f, jnp.asarray(x), tree["lora_A"], tree["lora_B"])
    ref = vjp(jnp.asarray(g))
    layer = tlinear.QuantLinear(64, 96, 4, 32) if quantized else tlinear.Linear(64, 96, dtype=torch.float32)
    jax_bridge.load_jax_params(layer, params)
    xt = torch.from_numpy(x).requires_grad_()
    a, b = layer.lora_A.requires_grad_(), layer.lora_B.requires_grad_()
    got = torch.autograd.grad(tlinear.linear(layer, xt), (xt, a, b), torch.from_numpy(g))
    for u, w in zip(got, ref):
        np.testing.assert_allclose(u.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def trained_tree():
    """A JAX tree with adapters on the default targets and random factors."""
    return _with_random_factors(_jax_injected(None))


def test_bridge_round_trip_with_lora_leaves_is_bit_exact(trained_tree):
    model = tm.LTXModel(TCFG, device="cpu", dtype=torch.float32)
    jax_bridge.load_jax_params(model, trained_tree)
    back = jax_bridge.module_to_jax_tree(model)
    assert jax.tree.structure(back) == jax.tree.structure(trained_tree)
    for x, y in zip(jax.tree.leaves(trained_tree), jax.tree.leaves(back)):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_exported_adapter_matches_jax_and_reads_back(tmp_path, trained_tree):
    model = tm.LTXModel(TCFG, device="cpu", dtype=torch.float32)
    jax_bridge.load_jax_params(model, trained_tree)
    ref = jlora.export_lora_state(trained_tree, CFG)
    got = tlora.export_lora_state(model, TCFG)
    assert sorted(got) == sorted(ref)
    assert all(k.startswith("diffusion_model.transformer_blocks.") for k in got)
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), ref[key])

    path = tmp_path / "lora_step_3.safetensors"
    tlora.save_lora(path, model, TCFG)
    read = jlora.load_lora_state(path)
    assert sorted(read) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(read[key], ref[key])
    # and the JAX continue-training loader puts the same factors back
    fresh = _jax_injected(None)
    loaded = _lora_leaves(jlora.load_lora_into_params(fresh, path, CFG))
    for p, leaf in _lora_leaves(trained_tree).items():
        if p[-1] != "lora_scale":
            np.testing.assert_array_equal(loaded[p], leaf)


def test_load_lora_into_params_round_trip(tmp_path, trained_tree):
    model = tm.LTXModel(TCFG, device="cpu", dtype=torch.float32)
    jax_bridge.load_jax_params(model, trained_tree)
    tlora.save_lora(tmp_path / "a.safetensors", model, TCFG)
    fresh = tm.init_ltx_params(TCFG, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    tlora.inject_lora(fresh, TCFG, tlora.LoRAConfig(rank=4, alpha=8.0), torch.Generator().manual_seed(2))
    tlora.load_lora_into_params(fresh, tmp_path / "a.safetensors", TCFG)
    want = dict(model.named_parameters())
    for name, p in fresh.named_parameters():
        if ".lora_" in name:
            assert torch.equal(p, want[name]), name
    other = tm.init_ltx_params(TCFG, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    tlora.inject_lora(other, TCFG, tlora.LoRAConfig(rank=2), torch.Generator().manual_seed(2))
    with pytest.raises(ValueError, match="lora_rank"):
        tlora.load_lora_into_params(other, tmp_path / "a.safetensors", TCFG)
