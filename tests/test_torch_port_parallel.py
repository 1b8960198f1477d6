"""The port's parallel layer against the JAX package: start-up
(``parallel/distributed.py``), meshes (``mesh.py``), the collective layer
(``collectives.py``) and the Megatron TP / FSDP sharding (``sharding.py``).

Ranks are gloo processes started here (:func:`run_ranks`), joined through a
file store in ``tmp_path``; they import torch and the port only (JAX is
blocked in them). This process runs the JAX side on its virtual 8-device
CPU mesh and compares. Every process group has a 60 s timeout and the ranks
are killed past the deadline, so a deadlock fails one test.
"""

from __future__ import annotations

import os
import pickle
import signal
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_video_tpu.config import LTXModelConfig as JaxLTXConfig
from mlx_video_tpu.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu.models.ltx import model as jm
from mlx_video_tpu.ops import int8 as jint8
from mlx_video_tpu.ops import quant as jquant
from mlx_video_tpu.parallel import mesh as jmesh
from mlx_video_tpu.parallel import sharding as jsh
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.parallel import collectives as tcol
from mlx_video_tpu_torch.parallel import distributed as tdist
from mlx_video_tpu_torch.parallel import mesh as tmesh
from mlx_video_tpu_torch.parallel import sharding as tsh

REPO = Path(__file__).resolve().parents[1]
AXES = ("data", "fsdp", "tensor")

_PRELUDE = r'''
import pickle, sys
sys.modules["jax"] = sys.modules["ml_dtypes"] = sys.modules["flax"] = sys.modules["mlx_video_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(1)
from mlx_video_tpu_torch.parallel.distributed import initialize_multihost, shutdown
rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
with open(work + "/inputs.pkl", "rb") as f:
    inputs = pickle.load(f)
def join(store="store"):
    initialize_multihost(f"file://{work}/{store}", world, rank, device_type="cpu", timeout=60)
join()
out = {}
'''
_EPILOGUE = r'''
shutdown()
with open(f"{work}/out{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
'''


def run_ranks(body: str, world: int, work: Path, inputs=None, timeout: float = 240.0) -> list:
    """Run ``body`` in ``world`` gloo processes (after the prelude above has
    joined them: ``rank``, ``world``, ``work``, ``inputs`` and the dict
    ``out`` are defined); returns each rank's ``out``. Fails with the ranks'
    output when one exits non-zero or the deadline passes (all are killed)."""
    work.mkdir(parents=True, exist_ok=True)
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs or {}, f)
    script = work / "rank.py"
    script.write_text(_PRELUDE + textwrap.dedent(body) + _EPILOGUE)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), str(work)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"ranks did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(f"--- rank {r}\n{log[-4000:]}" for r, log in enumerate(logs))
    outs = []
    for r in range(world):
        with open(work / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def jax_mesh(shape):
    return jmesh.create_mesh(tuple(shape), devices=jax.devices()[: int(np.prod(shape))])


def port_config(cfg) -> tconfig.LTXModelConfig:
    return tconfig.LTXModelConfig.from_dict(cfg.to_dict())


def jax_trees(num_layers: int = 2, seed: int = 5):
    """A tiny VideoOnly DiT's dense, q4 (group 64) and W8A8 trees (numpy):
    the JAX init's linears, with seeded biases, norm weights and tables in
    place of its zeros and ones."""
    cfg = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT, num_layers=num_layers)
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
    q4 = jax.tree.map(np.asarray, jquant.quantize_dit_params(jax.tree.map(jnp.asarray, dense), group_size=64, bits=4))
    w8 = jax.tree.map(np.asarray, jint8.quantize_params_w8a8(jax.tree.map(jnp.asarray, dense)))
    return cfg, {"dense": dense, "q4": q4, "w8a8": w8}


# ---------------------------------------------------------------------------
# Specs on the full-width 19B trees
# ---------------------------------------------------------------------------


def _full_tree(kind: str):
    cfg = JaxLTXConfig(model_type=LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)

    def build():
        p = jm.init_ltx_params(jax.random.key(0), cfg, dtype=jnp.bfloat16)
        if kind == "q4":
            p = jquant.quantize_dit_params(p, group_size=64, bits=4)
        elif kind == "w8a8":
            p = jint8.quantize_params_w8a8(p)
        return p

    return cfg, jax.eval_shape(build)


@pytest.mark.parametrize("kind", ["dense", "q4", "w8a8"])
def test_specs_match_jax_on_every_leaf_of_the_full_19b_trees(kind):
    """The copy of ``spec_for_path`` gives JAX's spec for every leaf; the
    port's spec of each port tensor is JAX's in the port's layout: the
    stack's axis dropped, the dimensions moved as io/jax_bridge.py moves
    them (a dense ``weight`` and ``int8_weight`` transposed)."""
    cfg, tree = _full_tree(kind)
    jspecs = jsh.param_specs(tree)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    n_sharded = 0
    for path, leaf in leaves:
        path_str = jsh._path_str(path)
        want = tuple(_at(jspecs, path))
        assert tsh.spec_for_path(path_str, leaf.ndim) == want, path_str
        stacked = path_str.startswith("blocks/")
        name = path_str.replace("/", ".").replace("blocks.", "blocks.0.", 1) if stacked else path_str.replace("/", ".")
        local = want[1:] if stacked else want
        leafname = path_str.rsplit("/", 1)[-1]
        if len(local) == 2 and leafname in ("weight", "int8_weight"):
            local = tuple(local[i] for i in jax_bridge._TO_TORCH[2])
        assert tsh.port_spec(name, leaf.ndim - stacked) == local, name
        n_sharded += any(e is not None for e in local)
    assert n_sharded >= 20
    if kind == "dense":  # every tensor of the port's own full-width model is covered
        model = tm.LTXModel(port_config(cfg), device="meta")
        specs = tsh.param_specs(model)
        assert len(specs) == len(list(model.named_parameters())) + len(list(model.named_buffers()))
        assert specs["blocks.47.attn1.to_q.weight"] == ("tensor", "fsdp")
        assert specs["blocks.47.attn1.to_out.weight"] == ("fsdp", "tensor")
        assert specs["video.proj_out.weight"] == (None, "tensor")


def _at(tree, path):
    for k in path:
        tree = tree[k.key] if hasattr(k, "key") else tree[k.idx]
    return tree


# ---------------------------------------------------------------------------
# Each rank's shards against JAX's per-device shards
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    return jax_trees()


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2), (2, 1, 2)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["dense", "q4", "w8a8"])
def test_each_rank_slice_equals_jax_addressable_shard(trees, kind, shape):
    """shard_params on virtual rank r keeps exactly the slice JAX's
    shard_params puts on virtual device r (in the port's layout), each a new
    contiguous tensor; a tensor nothing cuts stays the source's."""
    cfg, by_kind = trees
    tree = by_kind[kind]
    mesh = jax_mesh(shape)
    placed = jsh.shard_params(jax.tree.map(jnp.asarray, tree), mesh)
    model = jax_bridge.load_jax_params(tm.LTXModel(port_config(cfg), device="cpu", dtype=torch.float32), tree)
    source = dict(model.state_dict())
    devices = list(mesh.devices.flat)
    for r, mg in enumerate(tcol.virtual_meshes(shape, AXES, "cpu")):
        per_device = jax.tree.map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards if s.device == devices[r])), placed)
        want = jax_bridge.jax_tree_to_state_dict(per_device)
        got = tsh.shard_params(model, mg).state_dict()
        assert set(got) == set(want)
        for name, t in got.items():
            assert t.shape == want[name].shape and torch.equal(t, want[name].to(t.dtype)), (name, r)
            assert t.is_contiguous()
            cut = t.shape != source[name].shape
            assert (t.data_ptr() != source[name].data_ptr()) == cut, name  # an uncut tensor is the source's


def test_shard_params_refuses_indivisible_and_lora_and_resharding(trees):
    cfg, by_kind = trees
    model = jax_bridge.load_jax_params(tm.LTXModel(port_config(cfg), device="cpu", dtype=torch.float32),
                                       by_kind["dense"])
    with pytest.raises(ValueError, match="does not divide over tensor=3"):
        tsh.shard_params(model, tcol.virtual_meshes((1, 1, 3), AXES, "cpu")[0])
    mg = tcol.virtual_meshes((1, 1, 2), AXES, "cpu")[0]
    sharded = tsh.shard_params(model, mg)
    assert tsh.shard_params(sharded, mg) is sharded
    with pytest.raises(ValueError, match="already sharded"):
        tsh.shard_params(sharded, tcol.virtual_meshes((1, 1, 2), AXES, "cpu")[1])
    # row-parallel linears and the q/k norms carry the tensor group; column-parallel ones do not
    blk = sharded.blocks[0]
    assert blk.attn1.to_out.tp_group is mg.group("tensor") and blk.ff.proj_out.tp_group is mg.group("tensor")
    assert blk.attn1.q_norm.tp_group is mg.group("tensor")
    assert not hasattr(blk.attn1.to_q, "tp_group") and not hasattr(sharded.video.proj_out, "tp_group")
    # a model that carries LoRA factors shards them by their linear's tensor cut alone (A's in slice of a
    # row-parallel linear, B's out slice of a column-parallel one), never over fsdp
    from mlx_video_tpu_torch.lora import LoRAConfig, inject_lora

    inject_lora(model, port_config(cfg), LoRAConfig(rank=2), torch.Generator().manual_seed(0))
    mg = tcol.virtual_meshes((1, 2, 2), AXES, "cpu")[3]
    adapted = tsh.shard_params(model, mg)
    whole, cut = model.blocks[1], adapted.blocks[1]
    assert torch.equal(cut.attn1.to_q.lora_A, whole.attn1.to_q.lora_A)
    assert torch.equal(cut.attn1.to_q.lora_B, whole.attn1.to_q.lora_B.chunk(2, dim=0)[1])
    assert torch.equal(cut.attn1.to_out.lora_A, whole.attn1.to_out.lora_A.chunk(2, dim=1)[1])
    assert torch.equal(cut.attn1.to_out.lora_B, whole.attn1.to_out.lora_B)
    assert adapted.shard_specs["blocks.1.ff.proj_out.lora_A"] == (None, "tensor")


def test_data_spec_and_shard_batch_cut_the_batch_axis():
    assert tsh.data_spec(3) == tuple(jsh.data_spec(3))
    x = torch.arange(24.0).reshape(4, 3, 2)
    meshes = tcol.virtual_meshes((2, 1, 2), AXES, "cpu")
    parts = [tsh.shard_batch({"x": x, "y": (x, None)}, m) for m in meshes]
    assert torch.equal(parts[0]["x"], x[:2]) and torch.equal(parts[3]["y"][0], x[2:]) and parts[1]["y"][1] is None


# ---------------------------------------------------------------------------
# Start-up, single process (mirrors tests/test_distributed.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def no_launcher(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not torch.distributed.is_initialized()


def test_single_process_is_a_noop(no_launcher):
    assert tdist.initialize_multihost() is False
    assert not torch.distributed.is_initialized()


def test_partial_configs_raise_as_jax(no_launcher):
    with pytest.raises(ValueError, match="coordinator_address"):
        tdist.initialize_multihost(num_processes=2)
    with pytest.raises(ValueError, match="num_processes"):
        tdist.initialize_multihost(coordinator_address="h:1234", process_id=0)
    with pytest.raises(ValueError, match="process_id"):
        tdist.initialize_multihost(coordinator_address="h:1234", num_processes=2)
    with pytest.raises(ValueError, match="missing"):
        tdist.initialize_multihost(process_id=1)
    assert tdist.initialize_multihost(num_processes=1) is False


def test_torchrun_variables_configure_the_group(no_launcher, monkeypatch):
    """A partial launcher environment raises with JAX's message; the full one
    (torchrun's variables) joins a TCP group."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match=r"Partial multi-process config \(got num_processes; missing "
                                         r"coordinator_address, process_id\)"):
        tdist.initialize_multihost()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        assert tdist.initialize_multihost(device_type="cpu", timeout=30) is True
        assert torch.distributed.get_backend() == "gloo" and torch.distributed.get_world_size() == 1
        assert tdist.initialize_multihost() is True  # idempotent
        assert tdist.is_primary_host() and tdist.all_hosts_agree(3)
    finally:
        tdist.shutdown()
    assert not torch.distributed.is_initialized()


def test_single_process_helpers(no_launcher):
    assert tdist.is_primary_host()
    assert tdist.all_hosts_agree(42)
    assert tdist.backend_for("cuda") == "nccl" and tdist.backend_for("cpu") == "gloo"


def test_a_world_one_mesh_needs_no_launcher(no_launcher):
    """create_mesh in a process with no launcher joins a world-1 group of its
    own (an in-memory store); the (1, 1, 1) mesh has size-1 axes only."""
    try:
        mesh = tmesh.create_mesh((1, 1, 1), "cpu")
        assert tuple(mesh.shape) == (1, 1, 1) and mesh.mesh_dim_names == AXES
        mg = tcol.mesh_groups(mesh)
        assert all(isinstance(mg.group(a), tcol.SoloGroup) for a in AXES)
        with pytest.raises(ValueError, match=r"Mesh shape \(1, 2, 1\) does not cover 1 devices"):
            tmesh.create_mesh((1, 2, 1), "cpu")
    finally:
        tdist.shutdown()
    solo = tmesh.single_device_mesh("cpu")
    assert solo.shape == {"data": 1, "fsdp": 1, "tensor": 1}


class TestPreemptionGuard:
    def test_sigterm_sets_flag_and_restores_handler(self, no_launcher):
        before = signal.getsignal(signal.SIGTERM)
        with tdist.PreemptionGuard() as guard:
            assert not guard.preempted and not guard.should_checkpoint()
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.05)
            assert guard.preempted and guard.should_checkpoint()
        assert signal.getsignal(signal.SIGTERM) is before

    def test_install_idempotent(self):
        guard = tdist.PreemptionGuard()
        guard.install()
        first = signal.getsignal(signal.SIGTERM)
        guard.install()
        assert signal.getsignal(signal.SIGTERM) is first
        guard.uninstall()
        assert signal.getsignal(signal.SIGTERM) is not first


# ---------------------------------------------------------------------------
# Four gloo ranks: meshes, collectives, agreement
# ---------------------------------------------------------------------------

_FOUR_RANKS = r'''
from mlx_video_tpu_torch import loading
from mlx_video_tpu_torch.parallel import collectives, distributed, mesh as tmesh
mesh = tmesh.create_mesh((1, 2, 2), "cpu")
mg = collectives.mesh_groups(mesh)
out["coord"] = tuple(mesh.get_coordinate())
out["auto"] = tuple(loading.mesh_from_flag("auto", "cpu").shape)
try:
    tmesh.create_mesh((3, 1, 1), "cpu")
except ValueError as e:
    out["bad_shape"] = str(e)
x = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1)
for axis in ("fsdp", "tensor"):
    g = mg.group(axis)
    out[axis] = dict(sum=g.all_reduce(x), max=g.all_reduce(x - 3 * rank, "max"), gather=g.all_gather(x, dim=1),
                     shift=g.ring_shift(x), bcast=g.broadcast(x, src=1), int_sum=g.all_reduce(x.to(torch.int32)))
out["agree"] = distributed.all_hosts_agree(7)
out["disagree"] = distributed.all_hosts_agree(rank)
guard = distributed.PreemptionGuard()
out["quiet"] = guard.should_checkpoint(step=0)
guard.preempted = rank == 2
out["stop"] = guard.should_checkpoint(step=8)
out["off_step"] = guard.should_checkpoint(step=3)
out["primary"] = distributed.is_primary_host()
'''


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_ranks(_FOUR_RANKS, 4, tmp_path_factory.mktemp("four"))


def test_create_mesh_lays_ranks_out_row_major(four_ranks):
    assert [o["coord"] for o in four_ranks] == [tuple(int(c) for c in np.unravel_index(r, (1, 2, 2)))
                                                 for r in range(4)]
    jax_order = np.asarray(jax.devices()[:4]).reshape(1, 2, 2)
    assert [d.id for d in jax_order.flat] == [0, 1, 2, 3]  # JAX's layout of the same shape
    assert all(o["auto"] == tuple(jmesh.factor_devices(4)) == tmesh.factor_devices(4) for o in four_ranks)
    assert all(o["bad_shape"] == "Mesh shape (3, 1, 1) does not cover 4 devices" for o in four_ranks)


def test_collectives_on_gloo_match_the_virtual_form(four_ranks):
    """Each collective of the production form (gloo) gives what the virtual
    form gives, and what the axis's arithmetic says."""
    meshes = tcol.virtual_meshes((1, 2, 2), AXES, "cpu")

    def body(mg):
        r = int(np.ravel_multi_index([mg.index(a) for a in AXES], (1, 2, 2)))
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (r + 1)
        res = {}
        for axis in ("fsdp", "tensor"):
            g = mg.group(axis)
            res[axis] = dict(sum=g.all_reduce(x), max=g.all_reduce(x - 3 * r, "max"), gather=g.all_gather(x, dim=1),
                             shift=g.ring_shift(x), bcast=g.broadcast(x, src=1),
                             int_sum=g.all_reduce(x.to(torch.int32)))
        return res

    virtual = tcol.run_virtual(meshes, body)
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for r, (o, v) in enumerate(zip(four_ranks, virtual)):
        for axis in ("fsdp", "tensor"):
            for op, t in o[axis].items():
                assert torch.equal(t, v[axis][op]), (r, axis, op)
        peers = [r % 2, r % 2 + 2]  # rank r's fsdp group on the (1, 2, 2) mesh
        assert torch.equal(o["fsdp"]["sum"], base * sum(p + 1 for p in peers))
        prev = peers[(peers.index(r) - 1) % 2]
        assert torch.equal(o["fsdp"]["shift"], base * (prev + 1))
        assert torch.equal(o["tensor"]["bcast"], base * ((r // 2) * 2 + 2))
        assert o["tensor"]["int_sum"].dtype == torch.int32


def test_agreement_and_the_preemption_or_over_the_world(four_ranks):
    assert all(o["agree"] for o in four_ranks) and not any(o["disagree"] for o in four_ranks)
    assert not any(o["quiet"] for o in four_ranks)
    assert all(o["stop"] for o in four_ranks)  # one rank's signal stops every rank
    assert not any(o["off_step"] for o in four_ranks)  # no collective between sync steps
    assert [o["primary"] for o in four_ranks] == [True, False, False, False]


def test_a_failed_virtual_rank_raises_and_releases_the_others():
    meshes = tcol.virtual_meshes((1, 1, 2), AXES, "cpu")

    def body(mg):
        if mg.index("tensor") == 1:
            raise RuntimeError("rank 1 fails")
        return mg.group("tensor").all_reduce(torch.ones(2))

    with pytest.raises(RuntimeError, match="rank 1 fails"):
        tcol.run_virtual(meshes, body, timeout=30)
