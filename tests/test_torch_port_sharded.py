"""The port's sharded generation against the JAX package's: the rank-local
DiT forward (dense, q4, W8A8; TP, FSDP, SP), W8A8's all-reduced absmax,
GPipe, ``denoise`` and ``generate_video`` under a mesh and under stages,
and the generate CLI under four ranks.

One spawn of four gloo ranks (tests/test_torch_port_parallel.py:run_ranks:
torch and the port only) runs every case on the same seeded weights; this
process runs JAX's sharded functions on its virtual 8-device mesh. Bars,
with their reasons:
- forwards and GPipe: rtol 2e-4, atol 1e-5 in fp32 (sums reduced in
  another order);
- W8A8: the activation codes equal JAX's bit for bit (the max over the
  group is exact); a rank's own absmax gives other codes;
- denoise: JAX's own bar for its sharded loop, atol 5e-4;
- generate_video: >= 35 dB per latent and RGB frame (the pipeline gate),
  and the latents at rtol 2e-4 (atol 1e-5);
- the CLI: one mp4, written by rank 0 alone, >= 35 dB per frame against
  the unsharded CLI's mp4 (both through the same lossy codec).
"""

from __future__ import annotations

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_video_tpu.models.ltx import model as jm
from mlx_video_tpu.models.ltx.video_vae.decoder import DecoderConfig as JaxDecoderConfig
from mlx_video_tpu.ops.linear import linear as jlinear
from mlx_video_tpu.parallel import pipeline as jpp
from mlx_video_tpu.parallel import sharding as jsh
from mlx_video_tpu.pipelines import denoise as jdn
from mlx_video_tpu.pipelines import generate as jgen
from mlx_video_tpu.pipelines.positions import create_position_grid
from mlx_video_tpu_torch import loading as tloading
from mlx_video_tpu_torch.cli import generate as tcli
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.pipelines import denoise as tdn
from mlx_video_tpu_torch.pipelines import generate as tgen
from test_torch_port_cli import _tiny_bundle, emb_file  # noqa: F401 (fixture)
from test_torch_port_dev import DEC_KW, psnr
from test_torch_port_parallel import jax_mesh, jax_trees, port_config, run_ranks

LAYERS = 4
B, F, HT, WT = 2, 2, 4, 4  # forward inputs: 32 tokens, divisible by fsdp = 2
MESHES = {"1x1x2": (1, 1, 2), "1x2x2": (1, 2, 2), "2x1x2": (2, 1, 2)}
# (kind, mesh, sp) forward cases: every mesh with and without SP dense, two of each quantized form
FORWARDS = [("dense", m, sp) for m in MESHES for sp in (False, True)] + [
    (kind, m, sp) for kind in ("q4", "w8a8") for m, sp in (("1x2x2", True), ("2x1x2", False))]
# GPipe cases: (stages, data, tensor, microbatches, data_axis)
PIPES = [(2, 2, 1, 1, None), (2, 2, 1, 1, "data"), (4, 1, 1, 1, None), (4, 1, 1, 2, None), (2, 1, 2, 2, None)]
SIGMAS = [1.0, 0.5, 0.0]
GH = GW = 128  # generate_video: stage 1 at 64 x 64 (8 tokens), stage 2 at 128 x 128 (32)
GEN_SEED = 3

_CASES = r'''
import os
from pathlib import Path
from torch.distributed.device_mesh import DeviceMesh
from mlx_video_tpu_torch.cli import generate as cli
from mlx_video_tpu_torch import loading
from mlx_video_tpu_torch.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu_torch.io.jax_bridge import load_jax_params
from mlx_video_tpu_torch.models.ltx.model import LTXModel, Modality, ltx_apply
from mlx_video_tpu_torch.models.ltx.upsampler import init_latent_upsampler
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, init_video_decoder
from mlx_video_tpu_torch.ops.int8 import quantize_rows
from mlx_video_tpu_torch.ops.linear import linear
from mlx_video_tpu_torch.parallel import collectives, sharding
from mlx_video_tpu_torch.parallel import mesh as tmesh
from mlx_video_tpu_torch.parallel.distributed import is_primary_host
from mlx_video_tpu_torch.parallel.pipeline import pipeline_ltx_apply, pipeline_mesh, shard_params_pipeline
from mlx_video_tpu_torch.pipelines import denoise as dn
from mlx_video_tpu_torch.pipelines import generate as gen

AXES = ("data", "fsdp", "tensor")
cfg = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT, num_layers=inputs["layers"])
T = lambda a: torch.from_numpy(a)
def model(kind):
    return load_jax_params(LTXModel(cfg, device="cpu", dtype=torch.float32), inputs["trees"][kind])
vid = Modality(**{k: T(v) for k, v in inputs["video"].items()})
meshes = {name: tmesh.create_mesh(shape, "cpu") for name, shape in inputs["meshes"].items() if name != "1x1x2"}
meshes["1x1x2"] = DeviceMesh("cpu", torch.arange(2).reshape(1, 1, 2), mesh_dim_names=AXES)  # ranks 0 and 1

# the forwards
out["forward"] = {}
for kind, name, sp in inputs["forwards"]:
    mesh = meshes[name]
    if mesh.get_coordinate() is None:
        continue
    sharded = sharding.shard_params(model(kind), mesh)
    out["forward"][(kind, name, sp)] = ltx_apply(sharded, cfg, vid, sp=(mesh, "fsdp") if sp else None)[0].numpy()

# W8A8: the row-parallel ff.proj_out of block 0 on this rank's slice of its input
w8 = sharding.shard_params(model("w8a8"), meshes["1x2x2"])
mg = w8.mesh
tp, t = mg.group("tensor"), mg.index("tensor")
x = T(inputs["codes_x"])
step = x.shape[-1] // tp.size
x_local = x[..., t * step:(t + 1) * step].contiguous()
block0 = sharding.gather(w8.blocks[0], w8.shard_specs, mg, axes=("fsdp",), prefix="blocks.0.")
out["codes"] = (t, quantize_rows(x_local, tp)[0].numpy(), quantize_rows(x_local)[0].numpy(),
                linear(block0.ff.proj_out, x_local).numpy())

# GPipe
out["pipe"] = {}
for case in inputs["pipes"]:
    stages, data, tensor, m, data_axis = case
    staged = shard_params_pipeline(model("dense"), pipeline_mesh(stages, data=data, tensor=tensor, device_type="cpu"))
    out["pipe"][case] = pipeline_ltx_apply(staged, cfg, vid, num_microbatches=m, data_axis=data_axis)[0].numpy()

# denoise under SP and under stages
d = {k: T(v) for k, v in inputs["denoise"].items()}
mesh = meshes["1x2x2"]
out["denoise_sp"] = dn.denoise(sharding.shard_params(model("dense"), mesh), cfg, d["latents"], d["positions"],
                               d["context"], inputs["sigmas"], sequence_parallel=(mesh, "fsdp"))[0].numpy()
pp_mesh = pipeline_mesh(2, tensor=2, device_type="cpu")
staged = shard_params_pipeline(model("dense"), pp_mesh)
out["denoise_pp"] = dn.denoise(staged, cfg, d["latents"], d["positions"], d["context"], inputs["sigmas"],
                               pipeline_parallel=(pp_mesh, "pipe", 1, None))[0].numpy()

# generate_video, JAX's draws standing in for torch.randn
g = inputs["gen"]
class Draws:
    def __init__(self):
        self.left = [np.array(a) for a in g["draws"]]
    def __call__(self, size, *, generator=None, device=None, dtype=None):
        want = self.left.pop(0)
        assert tuple(size) == want.shape, (size, want.shape)
        return torch.from_numpy(want).to(device=device, dtype=dtype)
def bundle(dit_kind="dense"):
    dec_cfg = DecoderConfig(**g["dec_kw"])
    dec = init_video_decoder(torch.Generator().manual_seed(21), dec_cfg, device="cpu")
    dec.latents_mean.copy_(T(g["mean"]))
    dec.latents_std.copy_(T(g["std"]))
    ups = init_latent_upsampler(torch.Generator().manual_seed(22), 16, 32, 1, device="cpu")
    return gen.ModelBundle(model(dit_kind), cfg, dec, dec_cfg, ups)
real_randn = torch.randn
out["gen"] = {}
for what, kw in (("mesh_sp", dict(mesh=meshes["1x2x2"], sequence_parallel=True)),
                 ("pp", dict(pipeline_parallel=2, pipeline_tensor=2))):
    draws = Draws()
    torch.randn = draws
    path = Path(work) / f"{what}.mp4"
    res = gen.generate_video(bundle(), gen.TextConditioning(T(g["ctx"])), height=g["size"], width=g["size"],
                             num_frames=9, stage1_steps=2, stage2_steps=1, seed=g["seed"], tiling="none",
                             video_encoder="cv2", dtype=torch.float32, output_path=path, **kw)
    torch.randn = real_randn
    assert not draws.left
    out["gen"][what] = (res.latents, res.video, None if res.video_path is None else str(res.video_path))

# the CLI, under this launcher's group; main() leaves the group at its end
def tiny_cli_bundle():
    cfg2 = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)
    gg = torch.Generator().manual_seed(0)
    dec_cfg = DecoderConfig(in_channels=16, base_channels=32, num_layers_per_block=1)
    from mlx_video_tpu_torch.models.ltx.model import init_ltx_params
    return gen.ModelBundle(init_ltx_params(cfg2, gg, device="cpu", dtype=torch.float32), cfg2,
                           init_video_decoder(gg, dec_cfg, device="cpu"), dec_cfg,
                           init_latent_upsampler(gg, 16, 32, 1, device="cpu"))
loading.load_model_bundle = lambda *a, **k: tiny_cli_bundle()
from mlx_video_tpu_torch.io import media
writes, real_writer = [], media.VideoWriter
def writer(path, *a, **k):
    writes.append(Path(path).name)
    return real_writer(path, *a, **k)
media.VideoWriter = writer
for i, (what, flags) in enumerate((("mesh_sp", ["--mesh", "1,2,2", "--sequence-parallel"]),
                                   ("pp", ["--pipeline-parallel", "2", "--pipeline-tensor", "2"]))):
    if i:
        join(f"store_cli{i}")
    target = Path(work) / f"cli_{what}.mp4"
    cli.main(["--prompt", "a tiny cat", "--checkpoint-path", work, "--embeddings", inputs["emb"],
              "--height", "64", "--width", "64", "--num-frames", "9", "--stage1-steps", "1", "--stage2-steps", "1",
              "--tiling", "none", "--output-path", str(target), "--device", "cpu", *flags])
out["cli_writes"] = writes
'''


def _modality_np(seed: int = 1):
    rng = np.random.default_rng(seed)
    s = F * HT * WT
    return dict(latent=rng.normal(size=(B, s, 16)).astype(np.float32),
                timesteps=rng.uniform(0.2, 0.9, size=(B, 1)).astype(np.float32),
                context=rng.normal(size=(B, 8, 48)).astype(np.float32),
                positions=create_position_grid(B, F, HT, WT).astype(np.float32))


def _jax_modality(v):
    return jm.Modality(**{k: jnp.asarray(a) for k, a in v.items()})


def _gen_parts():
    """Narrow decoder and upsampler (port init, seeded), JAX's trees of them,
    the text context and JAX's three draws (stage 1, stage 2, decode)."""
    from mlx_video_tpu_torch.models.ltx import upsampler as tups
    from mlx_video_tpu_torch.models.ltx.video_vae import decoder as tdec

    rng = np.random.default_rng(20)
    mean, std = rng.normal(size=16).astype(np.float32) * 0.2, rng.uniform(0.8, 1.5, size=16).astype(np.float32)
    dec = tdec.init_video_decoder(torch.Generator().manual_seed(21), tdec.DecoderConfig(**DEC_KW), device="cpu")
    dec.latents_mean.copy_(torch.from_numpy(mean))
    dec.latents_std.copy_(torch.from_numpy(std))
    ups = tups.init_latent_upsampler(torch.Generator().manual_seed(22), 16, 32, 1, device="cpu")
    ctx = rng.normal(size=(1, 8, 48)).astype(np.float32)
    keys = jax.random.split(jax.random.key(GEN_SEED), 8)
    frames = 2
    s1, s2 = (1, 16, frames, GH // 64, GW // 64), (1, 16, frames, GH // 32, GW // 32)
    decode_cl = jax.random.normal(keys[2], (1, frames, GH // 32, GW // 32, 16), dtype=jnp.float32)
    draws = [np.asarray(jax.random.normal(keys[0], s1, dtype=jnp.float32)),
             np.asarray(jax.random.normal(keys[1], s2, dtype=jnp.float32)),
             np.transpose(np.asarray(decode_cl), (0, 4, 1, 2, 3))]
    trees = dict(dec=jax.tree.map(jnp.asarray, jax_bridge.module_to_jax_tree(dec)),
                 ups=jax.tree.map(jnp.asarray, jax_bridge.module_to_jax_tree(ups)))
    return dict(dec_kw=DEC_KW, mean=mean, std=std, ctx=ctx, draws=draws, seed=GEN_SEED, size=GH), trees


@pytest.fixture(scope="module")
def setup():
    cfg, trees = jax_trees(num_layers=LAYERS, seed=7)
    rng = np.random.default_rng(2)
    den = dict(latents=rng.normal(size=(1, 16, 2, 4, 4)).astype(np.float32),
               positions=create_position_grid(1, 2, 4, 4).astype(np.float32),
               context=rng.normal(size=(1, 4, 48)).astype(np.float32))
    gen, gen_trees = _gen_parts()
    return dict(cfg=cfg, trees=trees, video=_modality_np(), denoise=den, gen=gen, gen_trees=gen_trees,
                codes_x=(rng.normal(size=(B, 32, 512)) * rng.uniform(0.1, 3.0, size=(B, 32, 1))).astype(np.float32))


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    from mlx_video_tpu_torch.io.safetensors import save_safetensors

    work = tmp_path_factory.mktemp("sharded")
    emb = work / "emb.safetensors"
    save_safetensors(emb, {"video_prompt_embeds": torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, 48)).astype(np.float32))})
    inputs = dict(layers=LAYERS, trees=setup["trees"], video=setup["video"], meshes=MESHES, forwards=FORWARDS,
                  codes_x=setup["codes_x"], pipes=PIPES, denoise=setup["denoise"], sigmas=SIGMAS, gen=setup["gen"],
                  emb=str(emb))
    return run_ranks(_CASES, 4, work, inputs, timeout=400), work


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,mesh,sp", FORWARDS, ids=lambda v: str(v))
def test_sharded_forward_matches_jax_sharded_forward(setup, ranks, kind, mesh, sp):
    cfg = setup["cfg"]
    jmesh = jax_mesh(MESHES[mesh])
    with jmesh:
        params = jsh.shard_params(jax.tree.map(jnp.asarray, setup["trees"][kind]), jmesh)
        ref = np.asarray(jax.jit(lambda p: jm.ltx_apply(p, cfg, video=_jax_modality(setup["video"]),
                                                        sp=(jmesh, "fsdp") if sp else None)[0])(params))
    outs = [o["forward"][(kind, mesh, sp)] for o in ranks[0] if (kind, mesh, sp) in o["forward"]]
    assert len(outs) == int(np.prod(MESHES[mesh]))
    for got in outs:
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5)


def test_w8a8_codes_take_the_group_absmax(setup, ranks):
    """The row-parallel input's codes are JAX's codes of the whole token; a
    rank's own absmax gives other codes. The layer's output equals JAX's
    W8A8 linear on the whole input."""
    x = setup["codes_x"]
    absmax = np.abs(x).max(axis=-1, keepdims=True)
    scale = np.asarray(jnp.maximum(jnp.asarray(absmax) / 127.0, 1e-12))
    codes = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / scale), -127, 127).astype(jnp.int8))
    lin = setup["trees"]["w8a8"]["blocks"]["ff"]["proj_out"]
    ref = np.asarray(jlinear({k: jnp.asarray(v[0]) for k, v in lin.items()}, jnp.asarray(x)))
    step = x.shape[-1] // 2
    for out in ranks[0]:
        t, group_codes, local_codes, y = out["codes"]
        want = codes[..., t * step:(t + 1) * step]
        np.testing.assert_array_equal(group_codes, want)
        assert (local_codes != want).mean() > 0.1
        np.testing.assert_allclose(y, ref, rtol=2e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# GPipe, denoise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", PIPES, ids=lambda c: "P{}xD{}xT{}-M{}-{}".format(*c))
def test_gpipe_matches_jax_pipeline(setup, ranks, case):
    stages, data, tensor, m, data_axis = case
    cfg = setup["cfg"]
    mesh = jpp.pipeline_mesh(stages, data=data, tensor=tensor, devices=jax.devices()[:4])
    params = jpp.shard_params_pipeline(jax.tree.map(jnp.asarray, setup["trees"]["dense"]), mesh)
    ref = np.asarray(jax.jit(lambda p: jpp.pipeline_ltx_apply(
        p, cfg, video=_jax_modality(setup["video"]), mesh=mesh, num_microbatches=m, data_axis=data_axis)[0])(params))
    for out in ranks[0]:
        np.testing.assert_allclose(out["pipe"][case], ref, rtol=2e-4, atol=1e-5)


def test_denoise_under_sp_and_pp_matches_jax(setup, ranks):
    cfg, d = setup["cfg"], {k: jnp.asarray(v) for k, v in setup["denoise"].items()}
    params = jax.tree.map(jnp.asarray, setup["trees"]["dense"])
    mesh = jax_mesh((1, 2, 2))
    ref_sp, _ = jdn.denoise(params, cfg, d["latents"], d["positions"], d["context"], SIGMAS,
                            sequence_parallel=(mesh, "fsdp"))
    pp_mesh = jpp.pipeline_mesh(2, tensor=2, devices=jax.devices()[:4])
    ref_pp, _ = jdn.denoise(jpp.shard_params_pipeline(params, pp_mesh), cfg, d["latents"], d["positions"],
                            d["context"], SIGMAS, pipeline_parallel=(pp_mesh, "pipe", 1, None))
    for out in ranks[0]:
        np.testing.assert_allclose(out["denoise_sp"], np.asarray(ref_sp), atol=5e-4)
        np.testing.assert_allclose(out["denoise_pp"], np.asarray(ref_pp), atol=5e-4)


def test_denoise_refuses_what_jax_refuses(setup):
    """JAX's validations, raised before any collective."""
    cfg, d = port_config(setup["cfg"]), {k: torch.from_numpy(v) for k, v in setup["denoise"].items()}
    model = jax_bridge.load_jax_params(tm.LTXModel(cfg, device="cpu", dtype=torch.float32), setup["trees"]["dense"])
    args = (model, cfg, d["latents"], d["positions"], d["context"], SIGMAS)
    pp, sp = (object(), "pipe", 1, None), (object(), "fsdp")
    with pytest.raises(ValueError, match="pipeline_parallel and sequence_parallel are mutually exclusive"):
        tdn.denoise(*args, pipeline_parallel=pp, sequence_parallel=sp)
    with pytest.raises(ValueError, match=r"batch=1 not divisible by pipeline num_microbatches=2"):
        tdn.denoise(*args, pipeline_parallel=(object(), "pipe", 2, None))
    with pytest.raises(ValueError, match="teacache_threshold does not compose with pipeline/sequence parallelism"):
        tdn.denoise(*args, teacache_threshold=0.1, sequence_parallel=sp)
    with pytest.raises(ValueError, match="attn_broadcast_interval does not compose with pipeline/sequence"):
        tdn.denoise(*args, attn_broadcast_interval=2, pipeline_parallel=pp)
    with pytest.raises(ValueError, match="num_layers=4 not divisible by pipe=3"):
        from mlx_video_tpu_torch.parallel import collectives, pipeline

        pipeline.shard_params_pipeline(model, collectives.virtual_meshes((1, 3), ("data", "pipe"), "cpu")[0])


# ---------------------------------------------------------------------------
# generate_video and the CLI
# ---------------------------------------------------------------------------


def _jax_generate(setup, tmp_path, **kw):
    gen, trees = setup["gen"], setup["gen_trees"]
    bundle = jgen.ModelBundle(jax.tree.map(jnp.asarray, setup["trees"]["dense"]), setup["cfg"], trees["dec"],
                              JaxDecoderConfig(**DEC_KW), upsampler_params=trees["ups"])
    return jgen.generate_video(bundle, jgen.TextConditioning(jnp.asarray(gen["ctx"])), height=GH, width=GW,
                               num_frames=9, stage1_steps=2, stage2_steps=1, seed=GEN_SEED, tiling="none",
                               video_encoder="cv2", dtype=jnp.float32, output_path=tmp_path / "jax.mp4", **kw)


@pytest.mark.parametrize("what", ["mesh_sp", "pp"])
def test_generate_video_sharded_matches_jax(setup, ranks, tmp_path, what):
    """Mesh (1, 2, 2) with SP, and 2 stages x 2 TP ways: every rank's latents
    and video against JAX's run with the same options; one mp4, from rank 0."""
    kw = dict(mesh=jax_mesh((1, 2, 2)), sequence_parallel=True) if what == "mesh_sp" else dict(
        pipeline_parallel=2, pipeline_tensor=2)
    ref = _jax_generate(setup, tmp_path, **kw)
    outs, work = ranks
    peak = float(np.abs(ref.latents).max())
    for r, out in enumerate(outs):
        latents, video, path = out["gen"][what]
        assert (path is not None) == (r == 0)
        np.testing.assert_allclose(latents, ref.latents, rtol=2e-4, atol=1e-5)
        assert min(psnr(latents[:, :, i], ref.latents[:, :, i], peak) for i in range(latents.shape[2])) >= 35.0
        assert min(psnr(video[:, :, i], ref.video[:, :, i], 2.0) for i in range(video.shape[2])) >= 35.0
    assert (work / f"{what}.mp4").stat().st_size > 0


def test_generate_video_refuses_audio_and_mixed_parallel_options(monkeypatch):
    bundle = _tiny_bundle()
    text = tgen.TextConditioning(torch.zeros(1, 4, 48))
    kw = dict(height=64, width=64, num_frames=9, stage1_steps=1, stage2_steps=1, dtype=torch.float32)
    # audio with stages is no longer refused as such: it meets generate_video's own audio checks
    with pytest.raises(ValueError, match="Joint audio requires an AudioVideo transformer config"):
        tgen.generate_video(bundle, text, audio=True, audio_mode="joint", pipeline_parallel=2, **kw)
    with pytest.raises(ValueError, match="pipeline_parallel is mutually exclusive with mesh/sequence_parallel"):
        tgen.generate_video(bundle, text, pipeline_parallel=2, sequence_parallel=True, **kw)
    with pytest.raises(ValueError, match="attn_broadcast_interval does not compose with pipeline_parallel"):
        tgen.generate_video(bundle, text, pipeline_parallel=2, attn_broadcast_interval=2, **kw)
    with pytest.raises(ValueError, match="generate_video runs a latent batch of 1"):
        tgen.generate_video(bundle, text, pipeline_parallel=2, pipeline_microbatches=2, **kw)


def _frames(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame.astype(np.float64))
    cap.release()
    return frames


def test_cli_under_four_ranks_writes_one_video_like_the_unsharded_cli(ranks, monkeypatch, tmp_path, emb_file):
    """``--mesh 1,2,2 --sequence-parallel`` and ``--pipeline-parallel 2
    --pipeline-tensor 2`` over four gloo ranks: rank 0 alone writes the mp4
    (each run adds exactly one file), and its frames match the unsharded
    CLI run's."""
    outs, work = ranks
    assert [o["cli_writes"] for o in outs] == [["cli_mesh_sp.mp4", "cli_pp.mp4"], [], [], []]
    monkeypatch.setattr(tloading, "load_model_bundle", lambda *a, **k: _tiny_bundle())
    plain = tmp_path / "plain.mp4"
    tcli.main(["--prompt", "a tiny cat", "--checkpoint-path", str(tmp_path), "--embeddings",
               str(work / "emb.safetensors"), "--height", "64", "--width", "64", "--num-frames", "9",
               "--stage1-steps", "1", "--stage2-steps", "1", "--tiling", "none", "--output-path", str(plain),
               "--device", "cpu"])
    ref = _frames(plain)
    assert len(ref) == 9
    for what in ("mesh_sp", "pp"):
        got = _frames(work / f"cli_{what}.mp4")
        assert len(got) == len(ref)
        assert min(psnr(a, b, 255.0) for a, b in zip(got, ref)) >= 35.0, what


def test_cli_takes_the_parallel_flags_and_refuses_audio_with_them(emb_file):
    """The four flags no longer exit as unported; a mesh or stages of more
    than one rank with no launcher exit naming torchrun, with --audio too
    (the AV DiT's sharded forward is ported, so nothing refuses --audio with
    them); --mesh with --pipeline-parallel exits as in JAX."""
    base = ["--prompt", "p", "--embeddings", str(emb_file), "--device", "cpu"]
    assert not hasattr(tcli, "_REFUSED")
    for flags, msg in ((["--mesh", "1,2,2"], "needs 4 processes: launch it with torchrun --nproc-per-node 4"),
                       (["--pipeline-parallel", "2", "--pipeline-tensor", "2"], "torchrun --nproc-per-node 4"),
                       (["--mesh", "1,1,2", "--audio"], "needs 2 processes: launch it with torchrun"),
                       (["--mesh", "1,1,2", "--pipeline-parallel", "2"], "mutually exclusive")):
        with pytest.raises(SystemExit, match=msg):
            tcli.main(base + flags)
