"""The port's mesh-resident upsample and VAE decode against the JAX package's:
the rank rule of JAX's ``spatial_sharding`` (parallel/sharding.py:
spatial_spec), the non-cyclic halo exchange on every group form, and the
upsampler and the decoder run on each rank's rows of H with halo rows at
every conv (models/ltx/video_vae/conv.py), gathered whole.

Ranks are virtual (parallel/collectives.py:VirtualGroup threads in this
process) over 2, 4 and 8 ranks, and one spawn of four gloo processes
(tests/test_torch_port_parallel.py:run_ranks: torch and the port only)
runs the halo exchange, the decode and the upsample on DistGroup's p2p.
JAX runs its mesh decode and upsample on its virtual 8-device CPU mesh, as
tests/test_parallel.py's TestMeshResidentAux does. Bars, with their
reasons: atol and rtol 1e-4 in fp32, JAX's own bar for its mesh run against
its single-device run (the convs sum their taps in another order on a
slice); the zero-halo control must miss that bar.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_video_tpu.models.ltx import upsampler as jups
from mlx_video_tpu.models.ltx.video_vae import decoder as jdec
from mlx_video_tpu.models.ltx.video_vae.tiling import TilingConfig
from mlx_video_tpu.parallel import sharding as jsh
from mlx_video_tpu.pipelines import generate as jgen
from mlx_video_tpu_torch.models.ltx import upsampler as tups
from mlx_video_tpu_torch.models.ltx.video_vae import decoder as tdec
from mlx_video_tpu_torch.parallel import collectives as tcol
from mlx_video_tpu_torch.parallel import sharding as tsh
from mlx_video_tpu_torch.pipelines import generate as tgen
from test_torch_port_parallel import AXES, jax_mesh, run_ranks
from test_torch_port_vae import DEC_KW, _shared

TOL = dict(atol=1e-4, rtol=1e-4)
MESHES = {2: (1, 2, 1), 4: (1, 2, 2), 8: (1, 2, 4)}  # 8 ranks over H = 8: one latent row a rank
TILING = TilingConfig(spatial_config=TilingConfig.spatial_only(128, 64).spatial_config,
                      temporal_config=TilingConfig.temporal_only(16, 8).temporal_config)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


# ---------------------------------------------------------------------------
# The rank rule
# ---------------------------------------------------------------------------

SPEC_MESHES = [(1, 2, 4), (2, 2, 2), (1, 1, 8), (1, 4, 2), (2, 1, 4), (8, 1, 1), (1, 2, 1), (2, 2, 1)]
SPEC_SHAPES = [
    (1, 16, 2, 8, 8),  # H divides every cut
    (2, 16, 3, 6, 4),  # H = 6 divides fsdp = 2 alone; the batch on data
    (1, 16, 2, 2, 8),  # H = 2: fsdp = 4 does not divide it, tensor = 2 does
    (4, 16, 2, 3, 8),  # H = 3 divides nothing: whole
    (3, 128, 2, 16, 16),  # a batch data does not divide
]


@pytest.mark.parametrize("mesh", SPEC_MESHES, ids=lambda m: "x".join(map(str, m)))
def test_spatial_spec_is_jax_spatial_sharding(mesh):
    """Every shape's spec equals JAX's spatial_sharding spec on the same
    mesh, and every rank's part (shard_spatial) gathers back whole."""
    jm = jax_mesh(mesh)
    ranks = tcol.virtual_meshes(mesh, AXES, "cpu")
    for shape in SPEC_SHAPES:
        want = tuple(jsh.spatial_sharding(jm, shape, h_axis=3).spec)
        want = want + (None,) * (len(shape) - len(want))
        assert tsh.spatial_spec(ranks[0], shape) == want, (mesh, shape)
        x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
        spec = tsh.spatial_spec(ranks[0], shape)
        parts = tcol.run_virtual(ranks, lambda mg: (tsh.shard_spatial(x, mg).shape,
                                                   tsh.gather_spatial(tsh.shard_spatial(x, mg), mg, spec)))
        for _, whole in parts:
            torch.testing.assert_close(whole, x, rtol=0, atol=0)
        assert len({p for p, _ in parts}) == 1


# ---------------------------------------------------------------------------
# The halo exchange
# ---------------------------------------------------------------------------


def _halos_of(n: int, rows_up: int, rows_down: int):
    """Each of ``n`` virtual ranks' (up, down) halos of its own (2, 3, r)
    slice, row values naming their rank and row."""
    meshes = tcol.virtual_meshes((1, n, 1), AXES, "cpu")

    def body(mg):
        r = mg.index("fsdp")
        x = (100 * r + torch.arange(3, dtype=torch.float32))[None, None, :].expand(2, 3, 3).contiguous()
        return mg.group("fsdp").halo_exchange(x, rows_up, rows_down, dim=2)

    return tcol.run_virtual(meshes, body)


def test_halo_exchange_takes_neighbour_rows_and_nothing_past_the_edges():
    assert tcol.SoloGroup().halo_exchange(torch.ones(2, 3), 1, 1, dim=1) == (None, None)
    for n, (rows_up, rows_down) in ((2, (1, 1)), (4, (2, 1)), (4, (0, 3))):
        halos = _halos_of(n, rows_up, rows_down)
        for r, (up, down) in enumerate(halos):
            if r == 0 or rows_up == 0:
                assert up is None
            else:
                np.testing.assert_array_equal(up[0, 0].numpy(), 100 * (r - 1) + np.arange(3 - rows_up, 3))
            if r == n - 1 or rows_down == 0:
                assert down is None
            else:
                np.testing.assert_array_equal(down[0, 0].numpy(), 100 * (r + 1) + np.arange(rows_down))
    with pytest.raises(ValueError, match="a halo of 4 rows"):
        _halos_of(2, 4, 1)


# ---------------------------------------------------------------------------
# Upsample and decode by rows
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stages():
    """The port's decoder (DEC_KW, 32x spatially: the tiling's scale) and
    upsampler with shared seeded weights as JAX trees, seeded latents and
    statistics, and JAX's references: its single-device and its (2, 2, 2)
    mesh upsample and decode, whole and tiled."""
    rng = np.random.default_rng(31)
    decoder = tdec.VideoDecoder(tdec.DecoderConfig(**DEC_KW))
    decoder.latents_mean.copy_(torch.from_numpy(rng.normal(size=(16,)).astype(np.float32) * 0.2))
    decoder.latents_std.copy_(torch.from_numpy(rng.uniform(0.8, 1.5, size=(16,)).astype(np.float32)))
    dec_params = _shared(decoder, seed=31)
    ups = tups.LatentUpsampler(16, 32, 1)
    ups_params = _shared(ups, seed=32)
    lat = rng.normal(size=(1, 16, 2, 8, 8)).astype(np.float32)
    tiled_lat = rng.normal(size=(1, 16, 3, 8, 6)).astype(np.float32)
    mean = rng.normal(size=(16,)).astype(np.float32)
    std = rng.uniform(0.5, 2.0, size=(16,)).astype(np.float32)
    jmodels = jgen.ModelBundle(None, None, dec_params, jdec.DecoderConfig(**DEC_KW))
    jmesh = jax_mesh((2, 2, 2))
    ref = {
        "decode": jgen.decode_latents(jmodels, jnp.asarray(lat), None, decode_timestep=0.05),
        "tiled": jgen.decode_latents(jmodels, jnp.asarray(tiled_lat), TILING, decode_timestep=0.05),
        "upsample": np.asarray(jups.upsample_latents(ups_params, jnp.asarray(lat), jnp.asarray(mean),
                                                     jnp.asarray(std))),
    }
    with jmesh:
        jmodels.vae_decoder_params = jsh.replicate_params(dec_params, jmesh)
        ref["decode_mesh"] = jgen.decode_latents(jmodels, jnp.asarray(lat), None, decode_timestep=0.05, mesh=jmesh)
        ref["tiled_mesh"] = jgen.decode_latents(jmodels, jnp.asarray(tiled_lat), TILING, decode_timestep=0.05,
                                                mesh=jmesh)
        ref["upsample_mesh"] = np.asarray(jups.upsample_latents(
            jsh.replicate_params(ups_params, jmesh), jsh.shard_spatial(jnp.asarray(lat), jmesh, h_axis=3),
            *jsh.replicate_params((jnp.asarray(mean), jnp.asarray(std)), jmesh)))
    models = tgen.ModelBundle(None, None, decoder, tdec.DecoderConfig(**DEC_KW), upsampler=ups)
    return dict(models=models, lat=torch.from_numpy(lat), tiled_lat=torch.from_numpy(tiled_lat),
                mean=torch.from_numpy(mean), std=torch.from_numpy(std), ref=ref)


def _upsample_by_rows(models, lat, mean, std, mg):
    spec = tsh.spatial_spec(mg, lat.shape)
    part = tups.upsample_latents(models.upsampler, tsh.shard_spatial(lat, mg), mean, std,
                                 rows=tsh.spatial_group(mg, spec))
    return tsh.gather_spatial(part, mg, spec).numpy()


def _on_virtual_ranks(n, fn):
    outs = tcol.run_virtual(tcol.virtual_meshes(MESHES[n], AXES, "cpu"), fn)
    for other in outs[1:]:  # every rank ends with the whole result
        np.testing.assert_array_equal(other, outs[0])
    return outs[0]


@pytest.mark.parametrize("n", sorted(MESHES))
def test_decode_and_upsample_by_rows_match_jax_and_the_whole_stage(stages, n):
    """generate.decode_latents(mesh=) and the row-split upsample over n
    ranks (at 8, one latent row a rank: the reflect edge reads the
    neighbour's row) against JAX's mesh run, JAX's single-device run and
    the port's whole stage."""
    models, lat, ref = stages["models"], stages["lat"], stages["ref"]
    whole = tgen.decode_latents(models, lat, None, decode_timestep=0.05)
    got = _on_virtual_ranks(n, lambda mg: tgen.decode_latents(models, lat, None, decode_timestep=0.05, mesh=mg))
    assert got.shape == (1, 3, 9, 256, 256)
    np.testing.assert_allclose(got, whole, **TOL)
    np.testing.assert_allclose(got, ref["decode_mesh"], **TOL)
    np.testing.assert_allclose(got, ref["decode"], **TOL)

    up_whole = tups.upsample_latents(models.upsampler, lat, stages["mean"], stages["std"]).numpy()
    up = _on_virtual_ranks(n, lambda mg: _upsample_by_rows(models, lat, stages["mean"], stages["std"], mg))
    assert up.shape == (1, 16, 2, 16, 16)
    np.testing.assert_allclose(up, up_whole, **TOL)
    np.testing.assert_allclose(up, ref["upsample_mesh"], **TOL)
    np.testing.assert_allclose(up, ref["upsample"], **TOL)


def test_tiled_decode_by_rows_and_the_noise_drawn_once(stages):
    """The tiled decode under a mesh (each tile cut by the rule on its own
    shape: a tile of 4 latent rows goes 1 row a rank over fsdp x tensor = 4,
    and on fsdp alone over (1, 2, 4)) against JAX's tiled mesh decode and
    the port's tiled decode;
    the decode noise is drawn once for the whole latents, so a mesh decode
    with a generator equals the whole decode with the same seed."""
    models, lat, ref = stages["models"], stages["tiled_lat"], stages["ref"]
    whole = tgen.decode_latents(models, lat, TILING, decode_timestep=0.05)
    for n in (4, 8):
        got = _on_virtual_ranks(n, lambda mg: tgen.decode_latents(models, lat, TILING, decode_timestep=0.05, mesh=mg))
        assert got.shape == (1, 3, 17, 256, 192)
        np.testing.assert_allclose(got, whole, **TOL)
        np.testing.assert_allclose(got, ref["tiled_mesh"], **TOL)
        np.testing.assert_allclose(got, ref["tiled"], **TOL)

    small = stages["lat"]
    noisy = tgen.decode_latents(models, small, None, decode_timestep=0.05, generator=torch.Generator().manual_seed(4))
    got = _on_virtual_ranks(4, lambda mg: tgen.decode_latents(
        models, small, None, decode_timestep=0.05, generator=torch.Generator().manual_seed(4), mesh=mg))
    np.testing.assert_allclose(got, noisy, **TOL)
    assert np.abs(noisy - tgen.decode_latents(models, small, None, decode_timestep=0.05)).max() > 1e-3


def test_zero_halos_miss_the_bar(stages, monkeypatch):
    """The control: the same row-split decode with every halo replaced by
    zero rows (the neighbours' rows never arrive) fails the 1e-4 bar."""
    models, lat = stages["models"], stages["lat"]
    whole = tgen.decode_latents(models, lat, None, decode_timestep=0.05)

    def zero_halos(self, x, rows_up, rows_down, dim):
        up, down = real(self, x, rows_up, rows_down, dim)
        return (None if up is None else torch.zeros_like(up)), (None if down is None else torch.zeros_like(down))

    real = tcol.VirtualGroup.halo_exchange
    monkeypatch.setattr(tcol.VirtualGroup, "halo_exchange", zero_halos)
    got = _on_virtual_ranks(4, lambda mg: tgen.decode_latents(models, lat, None, decode_timestep=0.05, mesh=mg))
    assert not np.allclose(got, whole, **TOL)
    assert np.abs(got - whole).max() > 1e-2


# ---------------------------------------------------------------------------
# DistGroup: four gloo processes
# ---------------------------------------------------------------------------

_RANKS = r'''
from mlx_video_tpu_torch.models.ltx import upsampler as tups
from mlx_video_tpu_torch.models.ltx.video_vae import decoder as tdec
from mlx_video_tpu_torch.parallel import mesh as tmesh, sharding as tsh
from mlx_video_tpu_torch.parallel.collectives import mesh_groups
from mlx_video_tpu_torch.pipelines import generate as tgen

torch.set_grad_enabled(False)
mg = mesh_groups(tmesh.create_mesh((1, 2, 2), "cpu"))
flat = mg.flat(("fsdp", "tensor"))
x = (100 * rank + torch.arange(3, dtype=torch.float32))[None, :].expand(2, 3).contiguous()
out["flat"] = (flat.rank, flat.size)
out["halo"] = [h if h is None else h.numpy() for h in flat.halo_exchange(x, 1, 2, dim=1)]
out["reduce_scatter"] = flat.reduce_scatter(torch.arange(8, dtype=torch.float32) * (rank + 1), dim=0).numpy()
dec = tdec.VideoDecoder(tdec.DecoderConfig(**inputs["dec_kw"]))
dec.load_state_dict(inputs["dec_state"])
ups = tups.LatentUpsampler(16, 32, 1)
ups.load_state_dict(inputs["ups_state"])
models = tgen.ModelBundle(None, None, dec, tdec.DecoderConfig(**inputs["dec_kw"]), upsampler=ups)
lat = torch.from_numpy(inputs["lat"])
out["decode"] = tgen.decode_latents(models, lat, None, decode_timestep=0.05, mesh=mg)
spec = tsh.spatial_spec(mg, lat.shape)
part = tups.upsample_latents(ups, tsh.shard_spatial(lat, mg), torch.from_numpy(inputs["mean"]),
                             torch.from_numpy(inputs["std"]), rows=tsh.spatial_group(mg, spec))
out["upsample"] = tsh.gather_spatial(part, mg, spec).numpy()
'''


def test_dist_group_halos_and_rows_on_four_gloo_ranks(stages, tmp_path):
    models, lat = stages["models"], stages["lat"]
    inputs = dict(dec_kw=DEC_KW, dec_state=models.vae_decoder.state_dict(), ups_state=models.upsampler.state_dict(),
                  lat=lat.numpy(), mean=stages["mean"].numpy(), std=stages["std"].numpy())
    outs = run_ranks(_RANKS, 4, tmp_path, inputs)
    whole = tgen.decode_latents(models, lat, None, decode_timestep=0.05)
    up_whole = tups.upsample_latents(models.upsampler, lat, stages["mean"], stages["std"]).numpy()
    for r, o in enumerate(outs):
        assert o["flat"] == (r, 4)  # (fsdp, tensor) flattened row-major
        up, down = o["halo"]
        assert (up is None) == (r == 0) and (down is None) == (r == 3)
        if up is not None:
            np.testing.assert_array_equal(up, np.full((2, 1), 100 * (r - 1) + 2.0))
        if down is not None:
            np.testing.assert_array_equal(down, np.tile(100 * (r + 1) + np.arange(2.0), (2, 1)))
        np.testing.assert_array_equal(o["reduce_scatter"], np.arange(2 * r, 2 * r + 2) * 10.0)
        np.testing.assert_allclose(o["decode"], whole, **TOL)
        np.testing.assert_allclose(o["upsample"], up_whole, **TOL)
