"""The port's DiT (mlx_video_tpu_torch) against the JAX package, on the CPU.

Shared weights cross between the frameworks through io/jax_bridge.py; inputs
come from a seeded numpy generator. Bars, each with its reason:
- elementwise ops and RoPE tables: 1e-5 absolute (fp32; the largest RoPE
  frequency, ~1.6e4, turns one ulp of it into ~4e-6 of cos/sin);
- the full forward on tiny_test_config(): 5e-4 relative to the output's
  largest value, the bar of tests/test_torch_cross_dit.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_video_tpu.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu.models.ltx import model as jm
from mlx_video_tpu.models.ltx import rope as jrope
from mlx_video_tpu.models.ltx.upsampler import init_latent_upsampler
from mlx_video_tpu.models.ltx.video_vae.decoder import DecoderConfig as JaxDecoderConfig
from mlx_video_tpu.models.ltx.video_vae.decoder import init_video_decoder
from mlx_video_tpu.ops import linear as jlinear
from mlx_video_tpu.ops import norms as jnorms
from mlx_video_tpu.pipelines.positions import create_position_grid
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.models.ltx import rope as trope
from mlx_video_tpu_torch.models.ltx.upsampler import LatentUpsampler
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, VideoDecoder
from mlx_video_tpu_torch.ops import linear as tlinear
from mlx_video_tpu_torch.ops import norms as tnorms

ATOL = 1e-5


def _port(cfg):
    """The same configuration as the port's own config class."""
    return tconfig.LTXModelConfig.from_dict(cfg.to_dict())


def _port_rope(rope_type):
    return tconfig.LTXRopeType(rope_type.value)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_rms_and_layer_norm_match(rng):
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3.0
    w = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w))), atol=ATOL, rtol=0,
    )
    np.testing.assert_allclose(
        tnorms.layer_norm(torch.from_numpy(x)).numpy(),
        np.asarray(jnorms.layer_norm(jnp.asarray(x))), atol=ATOL, rtol=0,
    )
    assert tnorms.rms_norm(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


def test_linear_matches(rng):
    params = _np(jlinear.init_linear(jax.random.key(0), 48, 80))
    params["bias"] = rng.normal(size=(80,)).astype(np.float32)
    x = rng.normal(size=(3, 7, 48)).astype(np.float32)
    layer = tlinear.Linear(48, 80, dtype=torch.float32)
    jax_bridge.load_jax_params(layer, params)
    np.testing.assert_allclose(
        tlinear.linear(layer, torch.from_numpy(x)).numpy(),
        np.asarray(jlinear.linear(jax.tree.map(jnp.asarray, params), jnp.asarray(x))),
        atol=ATOL, rtol=0,
    )


@pytest.mark.parametrize("rope_type", [LTXRopeType.SPLIT, LTXRopeType.INTERLEAVED])
@pytest.mark.parametrize("dim, heads", [(128, 4), (4096, 32)])
def test_rope_tables_match(rope_type, dim, heads):
    pos = create_position_grid(1, 2, 4, 4)
    kw = dict(max_pos=[20, 2048, 2048], use_middle_indices_grid=True,
              num_attention_heads=heads, rope_type=rope_type)
    ref = jrope.precompute_freqs_cis(jnp.asarray(pos), dim, **kw)
    got = trope.precompute_freqs_cis(torch.from_numpy(pos), dim, **{**kw, "rope_type": _port_rope(rope_type)})
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=0)


@pytest.mark.parametrize("rope_type", [LTXRopeType.SPLIT, LTXRopeType.INTERLEAVED])
def test_apply_rotary_emb_matches(rng, rope_type):
    pos = create_position_grid(1, 2, 3, 3)
    pe = jrope.precompute_freqs_cis(jnp.asarray(pos), 128, use_middle_indices_grid=True,
                                    num_attention_heads=4, rope_type=rope_type)
    x = rng.normal(size=(1, 18, 128)).astype(np.float32)
    ref = jrope.apply_rotary_emb(jnp.asarray(x), pe, rope_type)
    got = trope.apply_rotary_emb(
        torch.from_numpy(x), tuple(torch.from_numpy(np.array(t)) for t in pe), _port_rope(rope_type)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_timestep_embedding_matches():
    """Bar 1e-4: at t = 1000 one ulp of exp(exponent) moves the angle ~6e-5."""
    t = np.linspace(0.0, 1000.0, 7, dtype=np.float32)
    np.testing.assert_allclose(
        tm.timestep_embedding(torch.from_numpy(t), 256).numpy(),
        np.asarray(jm.timestep_embedding(jnp.asarray(t), 256)), atol=1e-4, rtol=0,
    )


def test_to_denoised_matches(rng):
    x = rng.normal(size=(1, 4, 2, 3, 3)).astype(np.float32)
    v = rng.normal(size=x.shape).astype(np.float32)
    np.testing.assert_array_equal(
        tm.to_denoised(torch.from_numpy(x), torch.from_numpy(v), np.float32(0.725)).numpy(),
        np.asarray(jm.to_denoised(jnp.asarray(x), jnp.asarray(v), np.float32(0.725))),
    )


def _randomize_(module, seed=0):
    """Non-zero biases and tables, so a wrong index cannot hide behind zeros."""
    g = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if name.endswith(("bias", "scale_shift_table")):
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    return module


@pytest.fixture(scope="module", params=[LTXRopeType.SPLIT, LTXRopeType.INTERLEAVED])
def dit(request):
    """Shared weights: the port's init, handed to JAX through the bridge."""
    cfg = tiny_test_config(LTXModelType.VideoOnly, rope_type=request.param)
    model = tm.init_ltx_params(_port(cfg), torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    _randomize_(model)
    params = jax.tree.map(jnp.asarray, jax_bridge.module_to_jax_tree(model))
    return cfg, params, model


def test_ltx_apply_matches(dit):
    """Per-token timesteps (B, S); the mask test below covers the shared (B, 1)."""
    cfg, params, model = dit
    rng = np.random.default_rng(1)
    b, f, h, w = 1, 2, 4, 4
    s = f * h * w
    tokens = rng.normal(size=(b, s, cfg.in_channels)).astype(np.float32)
    timesteps = np.linspace(0.1, 0.9, b * s, dtype=np.float32).reshape(b, s)
    context = rng.normal(size=(b, 6, cfg.caption_channels)).astype(np.float32)
    pos = create_position_grid(b, f, h, w)
    ref, _ = jm.ltx_apply(params, cfg, video=jm.Modality(
        latent=jnp.asarray(tokens), timesteps=jnp.asarray(timesteps),
        context=jnp.asarray(context), positions=jnp.asarray(pos),
    ))
    got = tm.ltx_apply(model, _port(cfg), tm.Modality(
        latent=torch.from_numpy(tokens), timesteps=torch.from_numpy(timesteps),
        context=torch.from_numpy(context), positions=torch.from_numpy(pos),
    ))
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() <= 5e-4


def test_ltx_apply_with_context_mask_matches(dit):
    cfg, params, model = dit
    rng = np.random.default_rng(2)
    tokens = rng.normal(size=(1, 8, cfg.in_channels)).astype(np.float32)
    context = rng.normal(size=(1, 6, cfg.caption_channels)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 1, 0]], dtype=np.int32)
    pos = create_position_grid(1, 2, 2, 2)
    ts = np.full((1, 1), 0.4, np.float32)
    ref, _ = jm.ltx_apply(params, cfg, video=jm.Modality(
        latent=jnp.asarray(tokens), timesteps=jnp.asarray(ts), context=jnp.asarray(context),
        positions=jnp.asarray(pos), context_mask=jnp.asarray(mask),
    ))
    got = tm.ltx_apply(model, _port(cfg), tm.Modality(
        latent=torch.from_numpy(tokens), timesteps=torch.from_numpy(ts),
        context=torch.from_numpy(context), positions=torch.from_numpy(pos),
        context_mask=torch.from_numpy(mask),
    ))
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() <= 5e-4


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x = np.asarray(x)
        assert x.shape == y.shape
        np.testing.assert_array_equal(x.astype(np.float32), y)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DEC_KW = dict(in_channels=16, base_channels=32, num_layers_per_block=2)
_TINY = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)


_INITS = {
    "dit": lambda key: jm.init_ltx_params(key, _TINY, dtype=jnp.float32),
    "upsampler": lambda key: init_latent_upsampler(key, in_channels=16, mid_channels=32, num_blocks=2),
    "decoder": lambda key: init_video_decoder(key, JaxDecoderConfig(**_DEC_KW)),
}


@functools.lru_cache(maxsize=None)
def _jax_tree(name):
    """The JAX init's tree, names and shapes (``jax.eval_shape``: traced, not
    run), filled with seeded random fp32 values."""
    rng = np.random.default_rng(3)
    shapes = jax.eval_shape(_INITS[name], jax.random.key(0))
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def _module(name, dtype):
    if name == "dit":
        return tm.LTXModel(_port(_TINY), device="cpu", dtype=dtype)
    if name == "upsampler":
        return LatentUpsampler(16, 32, 2, dtype=dtype)
    return VideoDecoder(DecoderConfig(**_DEC_KW), dtype=dtype)


@pytest.mark.parametrize("name", ["dit", "upsampler", "decoder"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bit_exact(name, dtype):
    """JAX -> port -> JAX returns every leaf bit for bit (bf16 comes back
    widened to fp32, which is exact), with the JAX tree's structure."""
    tree = _jax_tree(name)
    if dtype == "bfloat16":  # latent statistics stay fp32, as the JAX init keeps them
        tree = jax.tree_util.tree_map_with_path(
            lambda path, x: x if path[-1].key.startswith("latents_") else x.astype(jnp.bfloat16), tree
        )
    module = _module(name, _DTYPES[dtype])
    jax_bridge.load_jax_params(module, tree)
    _assert_trees_equal(tree, jax_bridge.module_to_jax_tree(module))


def test_init_ltx_params_matches_jax_layout_and_init():
    cfg = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)
    model = tm.init_ltx_params(_port(cfg), torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    ours = jax_bridge.module_to_jax_tree(model)
    ref = _np(jm.init_ltx_params(jax.random.key(0), cfg, dtype=jnp.float32))
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        got = ours
        for k in path:
            got = got[k.key]
        assert got.shape == leaf.shape, path
        name = path[-1].key
        if name in ("bias", "scale_shift_table"):
            assert not got.any(), path
        elif len(path) >= 2 and path[-2].key in ("q_norm", "k_norm"):
            assert (got == 1).all(), path
        else:  # uniform linear weights within +-1/sqrt(in), as JAX draws them
            bound = leaf.shape[-2] ** -0.5
            assert np.abs(got).max() <= bound and np.abs(got).max() > 0.5 * bound, path
