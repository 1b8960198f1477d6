"""The port's server under a launcher and its Gemma text encoder sharded
under a mesh, against the JAX package's.

One spawn of two gloo ranks (tests/test_torch_port_parallel.py:run_ranks:
torch and the port only) runs:
- the sharded encoder (``parallel/sharding.py:shard_params`` of the
  ``TextEncoderModel``) on meshes (1, 1, 2) and (1, 2, 1): the embeddings of
  padded token ids, and greedy Gemma generation;
- ``serve.main`` twice, on port 0, with a stub tokenizer and the narrow
  2-layer DiT: ``--mesh 1,1,2 --sequence-parallel`` from prompts (the
  encoder sharded too), a warm-up, a plain, a streamed and a LoRA request,
  an /enhance, a request that fails validation (400), one that fails inside
  generation on every rank (500), one that fails on rank 1 alone in the
  middle of denoising, with rank 0 inside the collectives of the same
  forward (500: rank 0's collectives are cancelled and every rank renews
  the mesh's groups), and the plain request again; then
  ``--pipeline-parallel 2 --max-batch 2`` on ``--embeddings``, two requests
  coalesced into one batched run. Rank 0 drives HTTP from ``ready``'s
  thread and shuts the server down; both ranks must exit 0 (the stop
  message) before the deadline.
JAX's draws stand in for ``torch.randn`` (by the generator's seed, so a
coalesced batch draws each video's own). This process runs JAX's sharded
encoder, ``generate_video`` on the same meshes and its attached adapter.
Bars, with their reasons:
- embeddings: rel L2 <= 5e-4, the bar of
  tests/test_torch_port_text_encoder.py (fp32 sums in another order);
  greedy tokens and the enhanced text: equal;
- served latents: rtol 2e-4 and >= 35 dB per latent frame, the bars of
  tests/test_torch_port_serve.py; the coalesced videos against JAX's single
  runs: rtol 2e-4, atol 1e-5 (batched forwards reduce in another order);
- the 400 text: JAX's, word for word.
"""

from __future__ import annotations

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_video_tpu import lora as jlora
from mlx_video_tpu.models import gemma3 as jg
from mlx_video_tpu.models.ltx import text_encoder as jte
from mlx_video_tpu.parallel import sharding as jsh
from mlx_video_tpu.pipelines import generate as jgen
from mlx_video_tpu_torch.io.safetensors import save_safetensors
from test_torch_port_conditioned import _adapter, _bundles, _dit, parts  # noqa: F401 (fixture)
from test_torch_port_dev import psnr
from test_torch_port_parallel import jax_mesh, run_ranks
from test_torch_port_text_encoder import _ids_and_mask, encoder_trees  # noqa: F401 (fixture)

MAX_LEN = 16  # the stub tokenizer's padded length
SIZE = dict(height=64, width=64, num_frames=9, stage1_steps=1, stage2_steps=1, tiling="none")
PROMPT = "a cat on a mat"
ENHANCE = dict(prompt="a dog", max_tokens=5, temperature=0)
ENC_MESHES = {"1x1x2": (1, 1, 2), "1x2x1": (1, 2, 1)}
LORA_SEED, PLAIN_SEED, STREAM_SEED, COALESCED, FAIL_SEED = 3, 1, 2, (4, 5), 6

# A tokenizer stand-in without ``transformers`` (defined once, run here and
# in the ranks): ids from the characters, left-padded to ``max_length``; the
# chat template and decode of tests/test_torch_port_enhance.py:StubTokenizer.
_TOKENIZER = r'''
class Tokenizer:
    eos_token_id = 1

    def __call__(self, prompt, return_tensors, max_length, truncation, padding):
        ids = [3 + ord(c) % 290 for c in prompt][:max_length]
        pad = max_length - len(ids)
        return {"input_ids": np.asarray([[0] * pad + ids], np.int64),
                "attention_mask": np.asarray([[0] * pad + [1] * len(ids)], np.int64)}

    def convert_tokens_to_ids(self, token):
        return 106 if token == "<end_of_turn>" else -1

    def apply_chat_template(self, messages, add_generation_prompt, return_tensors):
        text = "|".join(f"{m['role']}:{m['content']}" for m in messages)
        ids = [2, 3 + len(text) % 200] + [3 + ord(c) % 290 for c in text[:6] + text[-10:]]
        return np.asarray([ids], np.int64)

    def decode(self, tokens):
        return " ".join(f"t{t}" for t in tokens) + "  "
'''
exec(_TOKENIZER)  # noqa: S102 (Tokenizer, for the JAX encoder here)

_CASES = _TOKENIZER + r'''
import json, threading, time, urllib.error, urllib.request
from pathlib import Path
from mlx_video_tpu_torch import loading
from mlx_video_tpu_torch.cli import serve
from mlx_video_tpu_torch.models import gemma3
from mlx_video_tpu_torch.models.ltx import text_encoder as tte
from mlx_video_tpu_torch.parallel import sharding
from mlx_video_tpu_torch.parallel import mesh as tmesh
from mlx_video_tpu_torch.pipelines import denoise as den
from mlx_video_tpu_torch.pipelines import generate as gen

torch.set_grad_enabled(False)
T = torch.from_numpy
enc = inputs["encoder"]

# the sharded encoder
out["encode"] = {}
for name, shape in inputs["enc_meshes"].items():
    s = sharding.shard_params(enc["model"], tmesh.create_mesh(shape, "cpu"))
    v, a = tte.encode_tokens(s, enc["cfg"], T(enc["ids"]).long(), T(enc["mask"]))
    toks = gemma3.generate(s.language_model, enc["cfg"], enc["gen_ids"], max_new_tokens=6, temperature=0.0,
                           eos_token_ids=(999,))
    out["encode"][name] = (v.numpy(), a.numpy(), toks)

# the servers
class Draws:  # JAX's draws of each seed, in order
    def __init__(self, by_seed):
        self.left = {seed: [np.array(a) for a in draws] for seed, draws in by_seed.items()}
    def __call__(self, size, *, generator=None, device=None, dtype=None):
        want = self.left[generator.initial_seed()].pop(0)
        assert tuple(size) == want.shape, (size, want.shape)
        return torch.from_numpy(want).to(device=device, dtype=dtype)
torch.randn = Draws(inputs["draws"])
tte.LTX2TextEncoder.load = classmethod(lambda cls, *a, **k: cls(pickle.loads(enc["model_bytes"]), enc["cfg"],
                                                                 Tokenizer(), max_length=enc["max_len"]))
loading.load_model_bundle = lambda *a, **k: pickle.loads(inputs["bundle"])
# a failure planted on rank 1 alone: the second forward (stage 2's) of the
# request with the seed inputs["fail_seed"] raises before its collectives
real_apply, planted = den.ltx_apply, {"armed": False, "calls": 0}
def planted_apply(*a, **kw):
    if planted["armed"]:
        planted["calls"] += 1
        if planted["calls"] == 2:
            planted["armed"] = False
            raise RuntimeError("planted failure on rank 1")
    return real_apply(*a, **kw)
if rank == 1:
    den.ltx_apply = planted_apply
seen, real_generate = [], gen.generate_video
def recording(*a, **kw):
    planted.update(armed=kw.get("seed") == inputs["fail_seed"], calls=0)
    res = real_generate(*a, **kw)
    seen.append((kw.get("seeds") or [kw.get("seed")], res.latents))
    return res
gen.generate_video = recording

def post(base, payload, path="/generate"):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            body = r.read().decode()
            return r.status, [json.loads(l) for l in body.splitlines()] if payload.get("stream") else json.loads(body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())

def run_server(flags, requests, concurrent=False):
    got = {}
    def ready(httpd, service):
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        resident = service.models.transformer, [t for t in service.models.transformer.parameters()]
        def drive():
            try:
                if concurrent:
                    threads = [threading.Thread(target=lambda k=k, p=p: got.__setitem__(k, post(base, p)))
                               for k, p in requests]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join()
                else:
                    for k, p in requests:
                        got[k] = post(base, p, "/enhance" if k == "enhance" else "/generate")
                after = service.models.transformer, [t for t in service.models.transformer.parameters()]
                got["resident"] = resident[0] is after[0] and all(a is b for a, b in zip(resident[1], after[1]))
            finally:
                httpd.shutdown()
        threading.Thread(target=drive, daemon=True).start()
    serve.main(["--model-repo", work, "--port", "0", "--output-dir", str(Path(work) / "out"), "--device", "cpu",
                *flags], ready=ready)
    return got

out["serve1"] = run_server(inputs["serve1_flags"], inputs["serve1_requests"])
out["seen1"], seen[:] = list(seen), []
join("store_serve2")
out["serve2"] = run_server(inputs["serve2_flags"], inputs["serve2_requests"], concurrent=True)
out["seen2"] = list(seen)
'''


def _jax_draws(seed: int):
    """JAX's draws of a 64 x 64 x 9 distilled run: stage 1, stage 2, decode."""
    keys = jax.random.split(jax.random.key(seed), 8)
    s1 = np.asarray(jax.random.normal(keys[0], (1, 16, 2, 1, 1), dtype=jnp.float32))
    s2 = np.asarray(jax.random.normal(keys[1], (1, 16, 2, 2, 2), dtype=jnp.float32))
    dec = np.transpose(np.asarray(jax.random.normal(keys[2], (1, 2, 2, 2, 16), dtype=jnp.float32)), (0, 4, 1, 2, 3))
    return [s1, s2, dec]


def _requests(lora_name):
    req = dict(SIZE, prompt=PROMPT)
    return [("warm_plain", dict(req, seed=PLAIN_SEED)), ("stream", dict(req, seed=STREAM_SEED, stream=True)),
            ("lora", dict(req, seed=LORA_SEED, lora=lora_name, lora_strength=0.8)), ("enhance", ENHANCE),
            ("bad", dict(req, teacache_threshold=0.1)), ("fails", dict(req, stage2_steps=5)),
            ("rank1_fails", dict(req, seed=FAIL_SEED)), ("plain_again", dict(req, seed=PLAIN_SEED))]


@pytest.fixture(scope="module")
def setup(parts, encoder_trees, tmp_path_factory):  # noqa: F811
    jcfg, tcfg, tree, enc_model = encoder_trees
    work = tmp_path_factory.mktemp("sharded_serve")
    (work / "loras").mkdir()
    adapter = _adapter(work / "loras" / "style.safetensors", seed=9)
    port, jax_bundle = _bundles(parts, _dit(60))
    save_safetensors(work / "emb.safetensors", {"video": parts["ctx"][0]})
    ids, mask = _ids_and_mask(True)
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree, enc_model=enc_model, work=work, adapter=adapter, port=port,
                jax_bundle=jax_bundle, ids=ids, mask=mask, ctx=parts["ctx"],
                gen_ids=np.random.default_rng(6).integers(0, 300, size=(1, 6)).astype(np.int32))


@pytest.fixture(scope="module")
def ranks(setup):
    draws = {seed: _jax_draws(seed) * (2 if seed == PLAIN_SEED else 1)
             for seed in (0, PLAIN_SEED, STREAM_SEED, LORA_SEED, FAIL_SEED, *COALESCED)}
    enc = dict(model=setup["enc_model"], model_bytes=pickle.dumps(setup["enc_model"]), cfg=setup["tcfg"],
               ids=setup["ids"], mask=setup["mask"], gen_ids=setup["gen_ids"], max_len=MAX_LEN)
    inputs = dict(
        encoder=enc, enc_meshes=ENC_MESHES, draws=draws, fail_seed=FAIL_SEED, bundle=pickle.dumps(setup["port"]),
        serve1_flags=["--mesh", "1,1,2", "--sequence-parallel", "--lora-dir", str(setup["work"] / "loras"),
                      "--warmup", "64x64x9"],
        serve1_requests=_requests("style.safetensors"),
        serve2_flags=["--pipeline-parallel", "2", "--embeddings", str(setup["work"] / "emb.safetensors"),
                      "--max-batch", "2", "--batch-window", "5"],
        serve2_requests=[(f"c{s}", dict(SIZE, seed=s)) for s in COALESCED])
    return run_ranks(_CASES, 2, setup["work"], inputs, timeout=400)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_encoder(setup, mesh):
    with mesh:
        params = jsh.shard_params(jax.tree.map(jnp.asarray, setup["tree"]), mesh)
    return jte.LTX2TextEncoder(params, setup["jcfg"], Tokenizer(), max_length=MAX_LEN)  # noqa: F821 (exec above)


@pytest.mark.parametrize("mesh", list(ENC_MESHES))
def test_sharded_encoder_matches_jax_sharded_encoder(setup, ranks, mesh):
    """Both ranks' embeddings of padded prompts against JAX's sharded
    ``encode_tokens``, and their greedy tokens against JAX's generate."""
    jmesh = jax_mesh(ENC_MESHES[mesh])
    encoder = _jax_encoder(setup, jmesh)
    with jmesh:
        rv, ra = jte.encode_tokens(encoder.params, setup["jcfg"], jnp.asarray(setup["ids"]),
                                   jnp.asarray(setup["mask"]), True)
        ref_tokens = jg.generate(encoder.params["language_model"], setup["jcfg"], setup["gen_ids"],
                                 max_new_tokens=6, temperature=0.0, eos_token_ids=(999,))
    for out in ranks:
        v, a, toks = out["encode"][mesh]
        assert _rel_l2(v, rv) <= 5e-4 and _rel_l2(a, ra) <= 5e-4
        assert toks == ref_tokens and len(toks) == 6


def _jax_served(setup, seed, text, params=None, **kw):
    bundle = setup["jax_bundle"]
    if params is not None:
        bundle = dataclasses.replace(bundle, transformer_params=params)
    return jgen.generate_video(bundle, text, seed=seed, dtype=jnp.float32, video_encoder="cv2", **SIZE, **kw).latents


def test_sharded_server_from_prompts_matches_jax(setup, ranks):
    """``--mesh 1,1,2 --sequence-parallel`` from prompts through the sharded
    encoder: the plain, streamed and LoRA requests (and the plain one again,
    after a 400 and two 500s, the second from a failure on rank 1 alone in
    the middle of denoising) on every rank against JAX's ``generate_video`` on
    the same mesh with JAX's sharded encoder's embeddings; /enhance against
    JAX's greedy enhancement; the resident weights untouched."""
    jmesh = jax_mesh((1, 1, 2))
    encoder = _jax_encoder(setup, jmesh)
    with jmesh:
        video, audio = encoder.encode(PROMPT)
        text = jgen.TextConditioning(video, audio_embeddings=audio)
        kw = dict(mesh=jmesh, sequence_parallel=True)
        ref = {s: _jax_served(setup, s, text, **kw) for s in (PLAIN_SEED, STREAM_SEED)}
        params = jsh.shard_params(setup["jax_bundle"].transformer_params, jmesh)
        attached = jlora.attach_runtime_lora(params, [jlora.LoraSpec(setup["adapter"], 0.8)], setup["jax_bundle"].transformer_config)
        ref[LORA_SEED] = _jax_served(setup, LORA_SEED, text, params=attached, **kw)
        enhanced = encoder.enhance_t2v(ENHANCE["prompt"], max_new_tokens=5, temperature=0.0)
    got = ranks[0]["serve1"]
    assert got["warm_plain"][0] == 200 and got["lora"][0] == 200 and got["plain_again"][0] == 200
    events = got["stream"][1]
    assert got["stream"][0] == 200 and events[-1]["kind"] == "result"
    assert any(e.get("kind") == "denoise_step" for e in events)
    assert got["enhance"] == (200, got["enhance"][1]) and got["enhance"][1]["enhanced"] == enhanced
    assert got["bad"] == (400, {"error": "teacache_threshold/attn_broadcast_interval do not compose with this "
                                         "server's sequence/pipeline parallelism"})
    code, body = got["fails"]
    assert code == 500 and "stage2_steps must be 1, 2, or 3" in body["error"]
    code, body = got["rank1_fails"]
    assert code == 500 and "rank 1: RuntimeError: planted failure on rank 1" in body["error"]
    assert got["resident"] is True
    for out in ranks:
        seeds = [s for s, _ in out["seen1"]]
        assert seeds == [[0], [PLAIN_SEED], [STREAM_SEED], [LORA_SEED], [PLAIN_SEED]]  # warm-up first
        for (seed,), latents in out["seen1"][1:]:
            np.testing.assert_allclose(latents, ref[seed], rtol=2e-4, atol=1e-5)
            peak = float(np.abs(ref[seed]).max())
            assert min(psnr(latents[:, :, i], ref[seed][:, :, i], peak) for i in range(latents.shape[2])) >= 35.0


def test_pipelined_server_coalesces_like_jax_single_runs(setup, ranks):
    """``--pipeline-parallel 2 --max-batch 2``: two queued requests run as one
    batched generate_video on both ranks; each video equals JAX's single
    pipelined run of its seed."""
    text = jgen.TextConditioning(jnp.asarray(setup["ctx"].numpy()))
    ref = {s: _jax_served(setup, s, text, pipeline_parallel=2) for s in COALESCED}
    got = ranks[0]["serve2"]
    assert all(got[f"c{s}"][0] == 200 and got[f"c{s}"][1]["batched"] == 2 for s in COALESCED)
    for out in ranks:
        ((seeds, latents),) = out["seen2"]
        assert sorted(seeds) == list(COALESCED)
        for i, s in enumerate(seeds):
            np.testing.assert_allclose(latents[i:i + 1], ref[s], rtol=2e-4, atol=1e-5)


# The channel alone, at a world above 2: four units, each an all-reduce over
# the tensor group of a (1, 1, 3) mesh; the first fails on rank 2 before its
# all-reduce (ranks 0 and 1 are inside theirs), the third on rank 0.
_CHANNEL = r'''
from mlx_video_tpu_torch.parallel import collectives, distributed
from mlx_video_tpu_torch.parallel import mesh as tmesh

mesh = collectives.mesh_groups(tmesh.create_mesh((1, 1, world), "cpu"))
channel, tp = distributed.WorkChannel([mesh]), mesh.group("tensor")
def unit(fails):
    if rank == fails:
        raise RuntimeError(f"planted on rank {rank}")
    return float(tp.all_reduce(torch.ones(1))[0])
out["units"] = []
for fails in (world - 1, None, 0, None):
    seq = channel.publish({"fails": fails}) if rank == 0 else channel.receive()[0]
    value, error, others = channel.run(seq, lambda: unit(fails))
    out["units"].append((value, None if error is None else type(error).__name__, others))
'''


def test_work_channel_cancels_and_renews_after_one_rank_fails(tmp_path):
    """Three gloo ranks: a unit that fails on one rank before its collective
    cancels the other ranks' collective (they raise ``Cancelled``), every
    rank returns with every other rank's failure report, and the next unit's
    all-reduce runs on the renewed groups and sums over all three."""
    outs = run_ranks(_CHANNEL, 3, tmp_path, timeout=120)
    for r, out in enumerate(outs):
        def failed(by):
            reports = {o: f"RuntimeError: planted on rank {o}" if o == by else
                       "Cancelled: another rank failed this collective's unit of work" for o in range(3)}
            return (None, reports[r].split(":")[0], [f"rank {o}: {t}" for o, t in reports.items() if o != r])
        assert out["units"] == [failed(2), (3.0, None, []), failed(0), (3.0, None, [])]
