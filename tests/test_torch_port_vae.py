"""The port's upsampler and VAE decoder against the JAX package, on the CPU.

The port works channels-first (B, C, F, H, W) where the JAX package's VAE
internals are channels-last, so inputs to the JAX internals are transposed.
Weights are the port's init, handed to JAX through io/jax_bridge.py; inputs
and decode noise are numpy from a seeded generator. Bar: 5e-4 absolute in fp32, the bar of
tests/test_torch_cross_vae.py (convolutions over up to 27*64 taps summed in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_video_tpu.models.ltx import upsampler as jups
from mlx_video_tpu.models.ltx.video_vae import blocks as jblocks
from mlx_video_tpu.models.ltx.video_vae import conv as jconv
from mlx_video_tpu.models.ltx.video_vae import decoder as jdec
from mlx_video_tpu.models.ltx.video_vae import ops as jops
from mlx_video_tpu.models.ltx.video_vae.tiling import TilingConfig
from mlx_video_tpu.pipelines import generate as jgen
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.models.ltx import upsampler as tups
from mlx_video_tpu_torch.models.ltx.video_vae import blocks as tblocks
from mlx_video_tpu_torch.models.ltx.video_vae import conv as tconv
from mlx_video_tpu_torch.models.ltx.video_vae import decoder as tdec
from mlx_video_tpu_torch.models.ltx.video_vae import ops as tops
from mlx_video_tpu_torch.ops import linear as tlinear
from mlx_video_tpu_torch.pipelines import generate as tgen

ATOL = 5e-4


def _cl(x: np.ndarray) -> jnp.ndarray:
    """(B, C, F, H, W) numpy -> channels-last JAX array."""
    return jnp.asarray(np.transpose(x, (0, 2, 3, 4, 1)))


def _cf(x) -> np.ndarray:
    """Channels-last JAX array -> (B, C, F, H, W) numpy."""
    return np.transpose(np.asarray(x), (0, 4, 1, 2, 3))


def _shared(module, seed=0):
    """Shared weights: the port's init with non-zero biases and tables (so a
    wrong index cannot hide behind zeros), and the same values as a JAX tree."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (tconv.Conv3d, tconv.Conv2d)):
                tconv.init_conv_(m, g)
            elif isinstance(m, tblocks.AffineNorm):
                m.reset_()
            elif isinstance(m, tlinear.Linear):
                tlinear.init_linear_(m, g)
        for name, p in module.named_parameters():
            if name.endswith("scale_shift_table"):  # built uninitialised (torch.empty)
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            elif name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return jax.tree.map(jnp.asarray, jax_bridge.module_to_jax_tree(module))


def test_patchify_round_trip_matches(rng):
    x = rng.normal(size=(1, 3, 2, 8, 8)).astype(np.float32)
    got = tops.patchify(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), _cf(jops.patchify(_cl(x), 4)))
    back = tops.unpatchify(got, 4)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(back.numpy(), _cf(jops.unpatchify(_cl(got.numpy()), 4)))


def test_latent_normalization_matches(rng):
    x = rng.normal(size=(1, 8, 2, 3, 3)).astype(np.float32)
    mean = rng.normal(size=(8,)).astype(np.float32)
    std = rng.uniform(0.5, 2.0, size=(8,)).astype(np.float32)
    for tf, jf in ((tops.normalize_latents, jops.normalize_latents),
                   (tops.denormalize_latents, jops.denormalize_latents)):
        got = tf(torch.from_numpy(x), torch.from_numpy(mean), torch.from_numpy(std))
        np.testing.assert_allclose(got.numpy(), _cf(jf(_cl(x), jnp.asarray(mean), jnp.asarray(std))),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize(
    "kernel, stride, causal, padding_mode",
    [(3, 1, True, "zeros"), (3, 1, False, "reflect"), (3, 1, True, "reflect"),
     (1, 1, False, "zeros"), ((3, 3, 3), (1, 2, 2), False, "zeros")],
)
def test_causal_conv3d_matches(rng, kernel, stride, causal, padding_mode):
    conv = tconv.Conv3d(8, 12, kernel)
    params = _shared(conv)
    x = rng.normal(size=(1, 8, 4, 6, 6)).astype(np.float32)
    ref = jconv.causal_conv3d(params, _cl(x), kernel, stride, causal, padding_mode)
    got = tconv.causal_conv3d(conv, torch.from_numpy(x), kernel, stride, causal, padding_mode)
    np.testing.assert_allclose(got.numpy(), _cf(ref), atol=ATOL, rtol=0)


def test_pixel_and_group_norm_match(rng):
    x = rng.normal(size=(2, 64, 2, 3, 3)).astype(np.float32) * 2 + 0.5
    np.testing.assert_allclose(tblocks.pixel_norm(torch.from_numpy(x)).numpy(),
                               _cf(jblocks.pixel_norm(_cl(x))), atol=1e-5, rtol=0)
    norm = {"weight": rng.normal(size=(64,)).astype(np.float32),
            "bias": rng.normal(size=(64,)).astype(np.float32)}
    mod = tblocks.AffineNorm(64)
    jax_bridge.load_jax_params(mod, norm)
    got = tblocks.group_norm(mod, torch.from_numpy(x), 32, eps=1e-5)
    ref = jblocks.group_norm(jax.tree.map(jnp.asarray, norm), _cl(x), 32, eps=1e-5)
    np.testing.assert_allclose(got.numpy(), _cf(ref), atol=1e-5, rtol=0)


def test_resnet_block_with_shortcut_matches(rng):
    block = tblocks.ResnetBlock3D(8, 16)
    params = _shared(block)
    x = rng.normal(size=(1, 8, 3, 4, 4)).astype(np.float32)
    ref = jblocks.resnet_block(params, _cl(x))
    got = tblocks.resnet_block(block, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _cf(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("residual", [True, False])
def test_depth_to_space_upsample_matches(rng, residual):
    ups = tblocks.DepthToSpaceUpsample(16, (2, 2, 2), 2)
    params = _shared(ups)
    x = rng.normal(size=(1, 16, 3, 4, 4)).astype(np.float32)
    kw = dict(residual=residual, out_channels_reduction_factor=2, causal=False, padding_mode="reflect")
    ref = jblocks.depth_to_space_upsample(params, _cl(x), (2, 2, 2), **kw)
    got = tblocks.depth_to_space_upsample(ups, torch.from_numpy(x), (2, 2, 2), **kw)
    assert got.shape == (1, 8, 5, 8, 8)
    np.testing.assert_allclose(got.numpy(), _cf(ref), atol=ATOL, rtol=0)


def test_upsample_latents_matches(rng):
    ups = tups.LatentUpsampler(16, 32, 2)
    params = _shared(ups)
    latent = rng.normal(size=(1, 16, 2, 3, 3)).astype(np.float32)
    mean = rng.normal(size=(16,)).astype(np.float32) * 0.2
    std = rng.uniform(0.8, 1.5, size=(16,)).astype(np.float32)
    ref = jups.upsample_latents(params, jnp.asarray(latent), jnp.asarray(mean), jnp.asarray(std))
    got = tups.upsample_latents(ups, torch.from_numpy(latent), torch.from_numpy(mean), torch.from_numpy(std))
    assert got.shape == (1, 16, 2, 6, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


DEC_KW = dict(in_channels=16, base_channels=32, num_layers_per_block=1, num_upsamples=3, patch_size=4)


@pytest.fixture(scope="module")
def decoder():
    rng = np.random.default_rng(11)
    module = tdec.VideoDecoder(tdec.DecoderConfig(**DEC_KW))
    module.latents_mean.copy_(torch.from_numpy(rng.normal(size=(16,)).astype(np.float32) * 0.2))
    module.latents_std.copy_(torch.from_numpy(rng.uniform(0.8, 1.5, size=(16,)).astype(np.float32)))
    return _shared(module, seed=11), module


def test_video_decoder_with_timestep_and_noise_matches(decoder):
    """Non-causal, as generate_video decodes; causal padding is covered by
    test_causal_conv3d_matches."""
    causal = False
    params, module = decoder
    rng = np.random.default_rng(12)
    latent = rng.normal(size=(1, 16, 2, 2, 2)).astype(np.float32)
    timestep = np.array([0.05], np.float32)
    key = jax.random.key(7)
    jax_decoder = jax.jit(jdec.video_decoder_apply, static_argnames=("config", "causal"))
    ref = jax_decoder(params, jdec.DecoderConfig(**DEC_KW), jnp.asarray(latent),
                      causal=causal, timestep=jnp.asarray(timestep), noise_key=key)
    # the same decode noise JAX draws from ``key``, channels-first
    noise = np.array(_cf(jax.random.normal(key, (1, 2, 2, 2, 16), dtype=jnp.float32)))
    got = tdec.video_decoder_apply(module, tdec.DecoderConfig(**DEC_KW), torch.from_numpy(latent),
                                   causal=causal, timestep=torch.from_numpy(timestep),
                                   noise=torch.from_numpy(noise))
    assert got.shape == (1, 3, 9, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_tiled_decode_latents_matches(decoder, monkeypatch):
    params, module = decoder
    calls = []

    def counting_decoder(*args, **kw):
        calls.append(args[2].shape)
        return tdec.video_decoder_apply(*args, **kw)

    monkeypatch.setattr(tgen, "video_decoder_apply", counting_decoder)
    latent = np.random.default_rng(13).normal(size=(1, 16, 3, 4, 4)).astype(np.float32)
    tiling = TilingConfig(
        spatial_config=TilingConfig.spatial_only(64, 32).spatial_config,
        temporal_config=TilingConfig.temporal_only(16, 8).temporal_config,
    )
    jax_models = jgen.ModelBundle(None, None, params, jdec.DecoderConfig(**DEC_KW))
    ref = jgen.decode_latents(jax_models, jnp.asarray(latent), tiling, decode_timestep=0.05)
    models = tgen.ModelBundle(None, None, module, tdec.DecoderConfig(**DEC_KW))
    got = tgen.decode_latents(models, torch.from_numpy(latent), tiling, decode_timestep=0.05)
    assert got.shape == (1, 3, 17, 128, 128)
    assert len(calls) == 18  # the tiling really split: 2 temporal x 3 x 3 spatial tiles
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
