"""The port's sharded AudioVideo and AudioOnly DiTs against the JAX
package's: the rank-local forward (dense, q4, W8A8; TP, FSDP, data, SP),
GPipe with both streams and with the audio alone, runtime LoRA over a
TP + FSDP sharded DiT (with and without slots), the specs and tensor-
parallel marks of every AV tensor, and what is still refused.

One spawn of four gloo ranks (tests/test_torch_port_parallel.py:run_ranks:
torch and the port only) runs every case on the same seeded weights; this
process runs JAX's sharded functions on its virtual 8-device mesh. Bars,
with their reasons:
- forwards, GPipe and LoRA forwards: rtol 2e-4, atol 1e-5 in fp32 (sums
  reduced in another order: the bar of tests/test_torch_port_sharded.py);
- W8A8 forwards: rel L2 <= 1e-3 a stream, JAX's W8A8 DiT bar of
  tests/test_torch_port_int8.py (a one-ulp difference ahead of a linear moves
  an activation code by a step; the unsharded port and JAX already differ
  so on the AV DiT);
- under SP the port keeps the audio stream whole where JAX rings its
  self-attention (6 audio tokens divide fsdp = 2): the same function, so
  the same bar (ROADMAP §3, a deliberate difference).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_video_tpu import lora as jlora
from mlx_video_tpu.config import LTXModelConfig as JaxLTXConfig
from mlx_video_tpu.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu.models.ltx import model as jm
from mlx_video_tpu.ops import int8 as jint8
from mlx_video_tpu.ops import quant as jquant
from mlx_video_tpu.parallel import pipeline as jpp
from mlx_video_tpu.parallel import sharding as jsh
from mlx_video_tpu.pipelines.positions import create_audio_position_grid, create_position_grid
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.io.safetensors import save_safetensors
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.parallel import collectives as tcol
from mlx_video_tpu_torch.parallel import sharding as tsh
from test_torch_port_parallel import _at, jax_mesh, port_config, run_ranks

AXES = ("data", "fsdp", "tensor")
LAYERS = 4  # four stages of one block
B, F, HT, WT, AT = 2, 2, 4, 4, 6  # 32 video tokens and 6 audio tokens, both divisible by fsdp = 2
MESHES = {"1x1x2": (1, 1, 2), "1x2x2": (1, 2, 2), "2x1x2": (2, 1, 2)}
# (kind, mesh, sp): the AV DiT dense on every mesh with and without SP, each quantized form on two, the
# AudioOnly DiT on two
FORWARDS = [("dense", m, sp) for m in MESHES for sp in (False, True)] + [
    (kind, m, sp) for kind in ("q4", "w8a8") for m, sp in (("1x2x2", True), ("2x1x2", False))] + [
    ("audio_only", "1x1x2", False), ("audio_only", "1x2x2", True)]
# GPipe: (kind, stages, data, tensor, microbatches, data_axis)
PIPES = [("dense", 4, 1, 1, 2, None), ("dense", 2, 1, 2, 1, None), ("dense", 2, 2, 1, 1, "data"),
         ("audio_only", 4, 1, 1, 1, None), ("audio_only", 2, 1, 2, 2, None)]
LORA_ATTN = ("attn1.to_q", "attn1.to_out.0", "audio_attn1.to_v", "audio_attn1.to_out.0",
             "audio_to_video_attn.to_q", "audio_to_video_attn.to_out.0", "video_to_audio_attn.to_k",
             "video_to_audio_attn.to_out.0", "ff.net.2", "audio_ff.net.0.proj")
SLOT_RANK = 8
# the linears' names: JAX's default targets also give an AudioVideo model's audio and cross-modal q/k norms
# factors, which its forward then cannot scan (a reference defect, ROADMAP §3)
SLOT_TARGETS = ("to_q", "to_k", "to_v", "to_out", "ff.proj_in", "ff.proj_out")

_CASES = r'''
from torch.distributed.device_mesh import DeviceMesh
from mlx_video_tpu_torch import lora
from mlx_video_tpu_torch.models.ltx.model import Modality, ltx_apply
from mlx_video_tpu_torch.parallel import sharding
from mlx_video_tpu_torch.parallel import mesh as tmesh
from mlx_video_tpu_torch.parallel.pipeline import pipeline_ltx_apply, pipeline_mesh, shard_params_pipeline

AXES = ("data", "fsdp", "tensor")
torch.set_grad_enabled(False)  # inject_lora makes trainable slots
T = lambda a: torch.from_numpy(a)
mods = {name: Modality(**{k: T(v) for k, v in d.items()}) for name, d in inputs["mods"].items()}
meshes = {name: tmesh.create_mesh(shape, "cpu") for name, shape in inputs["meshes"].items() if name != "1x1x2"}
meshes["1x1x2"] = DeviceMesh("cpu", torch.arange(2).reshape(1, 1, 2), mesh_dim_names=AXES)  # ranks 0 and 1

def run(model, cfg, apply):
    v, a = apply(model, cfg, mods["video"] if cfg.model_type.video_enabled else None, mods["audio"])
    return None if v is None else v.numpy(), a.numpy()

def model_of(kind):
    return inputs["models"][kind], inputs["ao_cfg"] if kind == "audio_only" else inputs["cfg"]

out["forward"] = {}
for kind, name, sp in inputs["forwards"]:
    mesh = meshes[name]
    if mesh.get_coordinate() is None:
        continue
    model, cfg = model_of(kind)
    out["forward"][(kind, name, sp)] = run(sharding.shard_params(model, mesh), cfg,
                                           lambda m, c, v, a: ltx_apply(m, c, v, a, sp=(mesh, "fsdp") if sp else None))

out["pipe"] = {}
for case in inputs["pipes"]:
    kind, stages, data, tensor, m, data_axis = case
    model, cfg = model_of(kind)
    staged = shard_params_pipeline(model, pipeline_mesh(stages, data=data, tensor=tensor, device_type="cpu"))
    out["pipe"][case] = run(staged, cfg, lambda s, c, v, a: pipeline_ltx_apply(s, c, v, a, num_microbatches=m,
                                                                                  data_axis=data_axis))

# runtime LoRA over the TP + FSDP sharded DiT, attached after sharding, without and with slots
mesh = meshes["1x2x2"]
spec = [lora.LoraSpec(inputs["adapter"], 0.7)]
model, cfg = model_of("dense")
base = sharding.shard_params(model, mesh)
out["lora"] = run(lora.attach_runtime_lora(base, spec, cfg), cfg, ltx_apply)
slotted = lora.inject_lora(sharding.shard_params(model, mesh), cfg,
                           lora.LoRAConfig(rank=inputs["slot_rank"], target_modules=inputs["slot_targets"]),
                           torch.Generator().manual_seed(0))
out["lora_slots"] = run(lora.attach_runtime_lora(slotted, spec, cfg, slot_rank=inputs["slot_rank"]), cfg, ltx_apply)
out["slots_base"] = run(slotted, cfg, ltx_apply)
'''


def _av_trees(seed: int = 7):
    """The tiny AudioVideo DiT's dense, q4 (group 32: two groups of the
    64-wide audio rows, one a rank under fsdp = 2) and W8A8 trees (numpy),
    with seeded biases, norm weights and tables, and its AudioOnly part."""
    cfg = tiny_test_config(LTXModelType.AudioVideo, rope_type=LTXRopeType.SPLIT, num_layers=LAYERS)
    rng = np.random.default_rng(seed)
    init = jax.tree.map(np.asarray, jm.init_ltx_params(jax.random.key(seed), cfg, dtype=jnp.float32))

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return (1.0 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if "bias" in name or "table" in name:
            return (0.05 * rng.normal(size=a.shape)).astype(np.float32)
        return a

    dense = jax.tree_util.tree_map_with_path(draw, init)
    q4 = jax.tree.map(np.asarray, jquant.quantize_dit_params(jax.tree.map(jnp.asarray, dense), group_size=32, bits=4))
    w8 = jax.tree.map(np.asarray, jint8.quantize_params_w8a8(jax.tree.map(jnp.asarray, dense)))
    blocks = {k: v for k, v in dense["blocks"].items()
              if k in ("audio_attn1", "audio_attn2", "audio_ff", "audio_scale_shift_table")}
    audio_only = {"audio": dense["audio"], "blocks": blocks}
    return cfg, {"dense": dense, "q4": q4, "w8a8": w8, "audio_only": audio_only}


def _modalities(seed: int = 1):
    rng = np.random.default_rng(seed)
    s = F * HT * WT
    return dict(
        video=dict(latent=rng.normal(size=(B, s, 16)).astype(np.float32),
                   timesteps=rng.uniform(0.2, 0.9, size=(B, 1)).astype(np.float32),
                   context=rng.normal(size=(B, 8, 48)).astype(np.float32),
                   positions=create_position_grid(B, F, HT, WT).astype(np.float32)),
        audio=dict(latent=rng.normal(size=(B, AT, 8)).astype(np.float32),
                   timesteps=rng.uniform(0.2, 0.9, size=(B, 1)).astype(np.float32),
                   context=rng.normal(size=(B, 5, 48)).astype(np.float32),
                   positions=create_audio_position_grid(B, AT).astype(np.float32)))


def _adapter(path, seed: int = 11, rank: int = 4):
    """A reference-format adapter on video, audio and cross-modal linears of
    both layers, column- and row-parallel ones alike."""
    rng = np.random.default_rng(seed)
    dims = {"attn1": (128, 128), "audio_attn1": (64, 64), "audio_to_video_attn.to_q": (128, 64),
            "audio_to_video_attn.to_out": (64, 128), "video_to_audio_attn.to_k": (128, 64),
            "video_to_audio_attn.to_out": (64, 64), "ff.net.2": (512, 128), "audio_ff.net.0.proj": (64, 256)}
    state = {}
    for i in range(LAYERS):
        for lin in LORA_ATTN:
            n_in, n_out = next(v for k, v in sorted(dims.items(), key=lambda kv: -len(kv[0])) if lin.startswith(k))
            state[f"diffusion_model.transformer_blocks.{i}.{lin}.lora_A.weight"] = torch.from_numpy(
                (rng.normal(size=(rank, n_in)) * 0.1).astype(np.float32))
            state[f"diffusion_model.transformer_blocks.{i}.{lin}.lora_B.weight"] = torch.from_numpy(
                (rng.normal(size=(n_out, rank)) * 0.1).astype(np.float32))
    save_safetensors(path, state)
    return path


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg, trees = _av_trees()
    ao_cfg = dataclasses.replace(cfg, model_type=LTXModelType.AudioOnly)
    models = {kind: jax_bridge.load_jax_params(
        tm.LTXModel(port_config(ao_cfg if kind == "audio_only" else cfg), device="cpu", dtype=torch.float32), tree)
        for kind, tree in trees.items()}
    work = tmp_path_factory.mktemp("sharded_av")
    return dict(cfg=cfg, ao_cfg=ao_cfg, trees=trees, models=models, mods=_modalities(),
                adapter=_adapter(work / "adapter.safetensors"), work=work)


@pytest.fixture(scope="module")
def ranks(setup):
    inputs = dict(models=setup["models"], cfg=port_config(setup["cfg"]), ao_cfg=port_config(setup["ao_cfg"]),
                  mods=setup["mods"], meshes=MESHES, forwards=FORWARDS, pipes=PIPES,
                  adapter=str(setup["adapter"]), slot_rank=SLOT_RANK, slot_targets=SLOT_TARGETS)
    return run_ranks(_CASES, 4, setup["work"], inputs, timeout=300)


def _jax_mods(setup, kind):
    m = {name: jm.Modality(**{k: jnp.asarray(a) for k, a in d.items()}) for name, d in setup["mods"].items()}
    return (None if kind == "audio_only" else m["video"]), m["audio"]


def _check(got, ref, w8a8: bool = False):
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is None:
            continue
        r = np.asarray(r)
        if w8a8:
            assert np.linalg.norm(g - r) / np.linalg.norm(r) <= 1e-3
        else:
            np.testing.assert_allclose(g, r, rtol=2e-4, atol=1e-5)


def _jax_forward(setup, kind, params, mesh, sp=False):
    cfg = setup["ao_cfg"] if kind == "audio_only" else setup["cfg"]
    video, audio = _jax_mods(setup, kind)
    with mesh:
        return jax.jit(lambda p: jm.ltx_apply(p, cfg, video=video, audio=audio,
                                              sp=(mesh, "fsdp") if sp else None))(params)


@pytest.mark.parametrize("kind,mesh,sp", FORWARDS, ids=lambda v: str(v))
def test_sharded_av_forward_matches_jax_sharded_forward(setup, ranks, kind, mesh, sp):
    """Every rank returns JAX's whole (video, audio) velocities."""
    jmesh = jax_mesh(MESHES[mesh])
    with jmesh:
        params = jsh.shard_params(jax.tree.map(jnp.asarray, setup["trees"][kind]), jmesh)
    ref = _jax_forward(setup, kind, params, jmesh, sp)
    outs = [o["forward"][(kind, mesh, sp)] for o in ranks if (kind, mesh, sp) in o["forward"]]
    assert len(outs) == int(np.prod(MESHES[mesh]))
    for got in outs:
        _check(got, ref, w8a8=kind == "w8a8")


@pytest.mark.parametrize("case", PIPES, ids=lambda c: "{}-P{}xD{}xT{}-M{}-{}".format(*c))
def test_gpipe_with_audio_matches_jax_pipeline(setup, ranks, case):
    """Both streams through the stages (and the audio alone), with TP inside
    the stages and microbatches, against jpp.pipeline_ltx_apply."""
    kind, stages, data, tensor, m, data_axis = case
    cfg = setup["ao_cfg"] if kind == "audio_only" else setup["cfg"]
    mesh = jpp.pipeline_mesh(stages, data=data, tensor=tensor, devices=jax.devices()[:4])
    params = jpp.shard_params_pipeline(jax.tree.map(jnp.asarray, setup["trees"][kind]), mesh)
    video, audio = _jax_mods(setup, kind)
    ref = jax.jit(lambda p: jpp.pipeline_ltx_apply(p, cfg, video=video, audio=audio, mesh=mesh,
                                                   num_microbatches=m, data_axis=data_axis))(params)
    for out in ranks:
        _check(out["pipe"][case], ref)


def test_runtime_lora_on_a_sharded_dit_matches_jax(setup, ranks):
    """The adapter attached over the (1, 2, 2)-sharded DiT (each rank keeps
    its factors' tensor slices), without and with rank-8 slots, against
    JAX's attach over its sharded params; the slotted base alone equals the
    sharded base (B = 0 slots)."""
    jmesh = jax_mesh((1, 2, 2))
    specs = [jlora.LoraSpec(setup["adapter"], 0.7)]
    with jmesh:
        params = jsh.shard_params(jax.tree.map(jnp.asarray, setup["trees"]["dense"]), jmesh)
        attached = jlora.attach_runtime_lora(params, specs, setup["cfg"])
        slotted = jlora.inject_lora(params, setup["cfg"], jlora.LoRAConfig(rank=SLOT_RANK, target_modules=SLOT_TARGETS),
                                    jax.random.key(0))
        slot_attached = jlora.attach_runtime_lora(slotted, specs, setup["cfg"], slot_rank=SLOT_RANK)
    ref = _jax_forward(setup, "dense", attached, jmesh)
    ref_slots = _jax_forward(setup, "dense", slot_attached, jmesh)
    base = _jax_forward(setup, "dense", params, jmesh)
    assert np.abs(np.asarray(ref[0]) - np.asarray(base[0])).max() > 1e-3  # the adapter moves the output
    for out in ranks:
        _check(out["lora"], ref)
        _check(out["lora_slots"], ref_slots)
        _check(out["slots_base"], base)


# ---------------------------------------------------------------------------
# Specs, marks and refusals (no ranks)
# ---------------------------------------------------------------------------


def test_specs_match_jax_on_every_leaf_of_the_full_19b_av_trees():
    """port_spec gives JAX's spec, in the port's layout, of every tensor of
    the 19B AudioVideo and AudioOnly DiTs: the audio branch, the cross-modal
    attentions, their 5-row tables and the four ``av_ca_*`` adaLNs."""
    for kind in (LTXModelType.AudioVideo, LTXModelType.AudioOnly):
        cfg = JaxLTXConfig(model_type=kind, rope_type=LTXRopeType.SPLIT)
        tree = jax.eval_shape(lambda: jm.init_ltx_params(jax.random.key(0), cfg, dtype=jnp.bfloat16))
        jspecs = jsh.param_specs(tree)
        model = tm.LTXModel(port_config(cfg), device="meta")
        specs = tsh.param_specs(model)
        names = set(specs)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            path_str = jsh._path_str(path)
            want = tuple(_at(jspecs, path))
            stacked = path_str.startswith("blocks/")
            name = path_str.replace("/", ".").replace("blocks.", "blocks.0.", 1) if stacked else path_str.replace(
                "/", ".")
            local = want[1:] if stacked else want
            if len(local) == 2 and path_str.endswith("/weight"):
                local = (local[1], local[0])
            assert specs[name] == local, name
            names.discard(name)
        assert not {n for n in names if not n.startswith("blocks.") or n.startswith("blocks.0.")}, names
        if kind == LTXModelType.AudioVideo:
            assert specs["blocks.0.audio_to_video_attn.to_q.weight"] == ("tensor", "fsdp")
            assert specs["blocks.0.video_to_audio_attn.to_out.weight"] == ("fsdp", "tensor")
            assert specs["blocks.0.scale_shift_table_a2v_ca_audio"] == (None, "fsdp")
            assert specs["av.av_ca_a2v_gate_adaln.linear.weight"] == ("tensor", "fsdp")


def test_tensor_parallel_marks_cover_the_audio_and_cross_modal_attentions(setup):
    """Sharding over tensor = 2 gives the tensor group to every row-parallel
    linear (the audio and both cross-modal ``to_out``, ``audio_ff.proj_out``)
    and every q/k norm of the audio and cross-modal attentions, and to no
    column-parallel linear."""
    mg = tcol.virtual_meshes((1, 1, 2), AXES, "cpu")[0]
    blk = tsh.shard_params(setup["models"]["dense"], mg).blocks[1]
    tp = mg.group("tensor")
    for attn in ("attn1", "attn2", "audio_attn1", "audio_attn2", "audio_to_video_attn", "video_to_audio_attn"):
        a = getattr(blk, attn)
        assert a.to_out.tp_group is tp and a.q_norm.tp_group is tp and a.k_norm.tp_group is tp, attn
        assert not any(hasattr(getattr(a, n), "tp_group") for n in ("to_q", "to_k", "to_v")), attn
    assert blk.ff.proj_out.tp_group is tp and blk.audio_ff.proj_out.tp_group is tp
    assert not hasattr(blk.audio_ff.proj_in, "tp_group")
    ao = tsh.shard_params(setup["models"]["audio_only"], mg)
    assert ao.blocks[0].audio_attn1.to_out.tp_group is tp and not hasattr(ao, "video")


def test_what_is_still_refused_names_it(setup):
    """A pipeline stage run as a whole model, a pipelined forward with no
    modality, a Gemma whose key/value heads the tensor axis does not divide,
    and the trainer's parallel options (the one ROADMAP item left)."""
    from mlx_video_tpu_torch.models import gemma3 as tg
    from mlx_video_tpu_torch.models.ltx import text_encoder as tte
    from mlx_video_tpu_torch.parallel import TRAINER_ITEM
    from mlx_video_tpu_torch.parallel import pipeline as tpp
    from mlx_video_tpu_torch.trainer import trainer as ttrainer

    cfg = port_config(setup["cfg"])
    mg = tcol.virtual_meshes((1, 1), ("data", "pipe"), "cpu")[0]
    staged = tpp.shard_params_pipeline(setup["models"]["dense"], mg)
    with pytest.raises(ValueError, match="a pipeline stage holds only its own blocks"):
        tm.ltx_apply(staged, cfg, None, None)
    with pytest.raises(ValueError, match="needs a video or an audio modality"):
        tpp.pipeline_ltx_apply(staged, cfg)
    gcfg = tg.Gemma3TextConfig(vocab_size=32, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                               num_attention_heads=4, num_key_value_heads=2, head_dim=8)
    encoder = tte.TextEncoderModel(gcfg, 16, device="meta")
    with pytest.raises(ValueError, match="tensor=4 does not divide the Gemma's 2 key/value heads"):
        tsh.shard_params(encoder, tcol.virtual_meshes((1, 1, 4), AXES, "cpu")[0])
    assert "sharded trainer" in TRAINER_ITEM
    assert "TRAINER_ITEM" not in dir(tm) and not hasattr(__import__("mlx_video_tpu_torch.parallel").parallel,
                                                          "SERVER_ITEM")
    assert ttrainer.PARALLEL_TRAIN.endswith(f"({TRAINER_ITEM})")
