"""The port's generation server (cli/serve.py) and runtime LoRA
(lora.py:attach_runtime_lora) against the JAX package, on the CPU, at narrow
width (the 2-layer split-RoPE DiT, the narrow decoder and upsampler, fp32),
served over loopback on port 0: the scenarios of tests/test_serve.py
(TestServe, TestDynamicBatching, TestServeLoRA, TestServeStreaming,
TestServeEnhance, TestLoraSlotServing), the same response keys and the same
400s as the JAX server, served latents against JAX's served latents, and
``main``'s loader path.

Bars, each with its reason:
- served latents against JAX's, on JAX's draws: rtol 2e-4 (the batched-video
  bar of tests/test_generate.py) and >= 35 dB per latent frame (the pipeline
  gate); a coalesced video against its single run: rtol 2e-4, atol 1e-5
  (JAX's own batched test: the batched forwards reduce in another order);
- a slotted base against the unslotted one, and the dials-off or base
  requests: bitwise (B = 0 slots add exact zeros);
- runtime adapters: the factors equal JAX's; a forward against JAX's
  attached tree rel L2 <= 1e-5 and against the port's merge <= 1e-5 (fp32
  products in another order), over a 4-bit base 5e-4 of the largest output
  (the quantized DiT bar of tests/test_torch_port_quant.py);
- 400 texts: word for word JAX's.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_port_conditioned import TCFG, _adapter, _bundles, _dit, _jax_dit, _JaxDraws, parts  # noqa: F401
from test_torch_port_dev import psnr

from mlx_video_tpu import lora as jlora
from mlx_video_tpu.cli import serve as jserve
from mlx_video_tpu.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu.models.ltx import model as jm
from mlx_video_tpu.ops import quant as jquant
from mlx_video_tpu.pipelines import generate as jgen
from mlx_video_tpu.pipelines.positions import create_position_grid
from mlx_video_tpu_torch import loading
from mlx_video_tpu_torch import lora as tlora
from mlx_video_tpu_torch.cli import serve as tserve
from mlx_video_tpu_torch.io.safetensors import save_safetensors
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.ops.quant import quantize_dit_params
from mlx_video_tpu_torch.pipelines import generate as tgen
from mlx_video_tpu_torch.utils import profiling

JCFG = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)
REQ = {"prompt": "a cat", "height": 64, "width": 64, "num_frames": 9, "stage1_steps": 1, "stage2_steps": 1,
       "tiling": "none"}
KEYS = {"path", "paths", "wall_seconds", "phases", "requests_served", "batched"}


def _text(parts):  # noqa: F811
    return tgen.TextConditioning(parts["ctx"])


def _service(parts, tmp_path, seed: int = 60, **kw):  # noqa: F811
    port, _ = _bundles(parts, _dit(seed))
    return tserve.GenerationService(port, default_text=_text(parts), output_dir=tmp_path, dtype=torch.float32, **kw)


def _jax_service(parts, tmp_path, seed: int = 60, **kw):  # noqa: F811
    _, bundle = _bundles(parts, _dit(seed))
    return jserve.GenerationService(bundle, default_text=jgen.TextConditioning(jnp.asarray(parts["ctx"].numpy())),
                                    output_dir=tmp_path, dtype=jnp.float32, **kw)


@pytest.fixture(scope="module")
def service(parts, tmp_path_factory):  # noqa: F811
    return _service(parts, tmp_path_factory.mktemp("serve_out"))


def _start(svc):
    httpd = tserve.serve(svc, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def server_url(service):
    httpd, url = _start(service)
    yield url
    httpd.shutdown()


def _post(url, payload, path="/generate", raw=None):
    req = urllib.request.Request(url + path, data=raw if raw is not None else json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Latents:
    """Wraps a package's generate_video to keep each result's latents (and
    each call's seeds)."""

    def __init__(self, monkeypatch, module):
        self.seen, self.seeds, inner = [], [], module.generate_video

        def wrapped(*a, **kw):
            result = inner(*a, **kw)
            self.seen.append(np.asarray(result.latents))
            self.seeds.append(kw.get("seeds") or [kw.get("seed")])
            return result

        monkeypatch.setattr(module, "generate_video", wrapped)


# --- TestServe ---

def test_healthz_and_generate(server_url, service):
    with urllib.request.urlopen(server_url + "/healthz") as r:
        body = json.loads(r.read())
    assert r.status == 200 and body["status"] == "ok"
    assert set(body) == {"status", "requests_served", "batches_run", "max_batch", "uptime_seconds"}
    code, out = _post(server_url, dict(REQ, seed=1))
    assert code == 200, out
    assert set(out) == KEYS and out["batched"] == 1 and out["paths"] is None
    assert {"stage1_denoise", "upsample", "stage2_denoise", "vae_decode"} <= set(out["phases"])
    code, out2 = _post(server_url, dict(REQ, seed=2))
    assert code == 200 and out2["path"] != out["path"] and out2["requests_served"] == service.requests_served
    assert all(open(p, "rb").read(4) for p in (out["path"], out2["path"]))


@pytest.mark.parametrize("lora", [None, "style.safetensors"])
def test_served_latents_match_jax_served_latents(parts, tmp_path, monkeypatch, lora):  # noqa: F811
    """One request through each server (the JAX one first, its draws then
    handed to the port); with an adapter, each attaches its own at run time."""
    lora_dir = tmp_path / "adapters"
    lora_dir.mkdir()
    _adapter(lora_dir / "style.safetensors", 61, rank=4)
    req = {"prompt": "a cat", "height": 128, "width": 128, "num_frames": 9, "stage1_steps": 2, "stage2_steps": 1,
           "tiling": "none", "seed": 3, **({"lora": lora} if lora else {})}
    jsvc = _jax_service(parts, tmp_path / "jax", lora_dir=lora_dir)
    tsvc = _service(parts, tmp_path / "port", lora_dir=lora_dir)
    jlat, tlat = _Latents(monkeypatch, jgen), _Latents(monkeypatch, tgen)
    ref = jsvc.generate(dict(req))
    keys = jax.random.split(jax.random.key(3), 8)
    draws = _JaxDraws([jax.random.normal(keys[0], (1, 16, 2, 2, 2), dtype=jnp.float32),
                       jax.random.normal(keys[1], (1, 16, 2, 4, 4), dtype=jnp.float32),
                       np.transpose(np.asarray(jax.random.normal(keys[2], (1, 2, 4, 4, 16), dtype=jnp.float32)),
                                    (0, 4, 1, 2, 3))])
    monkeypatch.setattr(torch, "randn", draws)
    got = tsvc.generate(dict(req))
    monkeypatch.undo()
    assert draws.draws == []
    assert set(got) == set(ref) == KEYS
    assert set(got["phases"]) <= set(ref["phases"]) | {"vae_decode"}
    (r,), (g,) = jlat.seen, tlat.seen
    peak = float(np.abs(r).max())
    np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4 * peak)
    assert min(psnr(g[:, :, i], r[:, :, i], peak) for i in range(2)) >= 35.0


BAD = [
    dict(pipeline="nope"),
    dict(pipeline="dev"),
    dict(low_memory=True),
    dict(num_frames={"oops": 1}),
    dict(cfg_scale=[1, 2]),
    dict(teacache_threshold=0.1, cfg_cache_interval=2),
    dict(teacache_threshold=0.1, attn_broadcast_interval=2),
    dict(attn_broadcast_interval=2, cfg_cache_interval=2),
    dict(cfg_sequential=True, attn_broadcast_interval=2),
    dict(audio=True, audio_mode="joint", teacache_threshold=0.1),
    dict(enhance_prompt=True),
    dict(lora="missing.safetensors"),
    dict(lora="../evil.safetensors"),
    dict(lora=["style.safetensors"], lora_strength=[1.0, 2.0]),
    dict(lora="style.safetensors", lora_strength="0.8"),
    dict(lora="style.safetensors", lora_strength=True),
    dict(lora={"name": "style"}),
    dict(lora=[1, 2]),
]


@pytest.fixture(scope="module")
def validators(parts, tmp_path_factory):  # noqa: F811
    """A JAX and a port service with the same adapter directory (no
    generation runs: validation only)."""
    root = tmp_path_factory.mktemp("validate")
    (root / "adapters").mkdir()
    _adapter(root / "adapters" / "style.safetensors", 62)
    return (_jax_service(parts, root / "jax", lora_dir=root / "adapters"),
            _service(parts, root / "port", lora_dir=root / "adapters"))


@pytest.mark.parametrize("bad", BAD)
def test_bad_requests_are_jax_400s(validators, server_url, bad):
    """The same RequestError text as the JAX server's, and a 400 over HTTP."""
    jsvc, tsvc = validators

    def message(svc, errors):
        with pytest.raises(errors) as info:
            svc._validate(dict(REQ, **bad))
        return str(info.value)

    assert message(tsvc, tserve.RequestError) == message(jsvc, jserve.RequestError)
    code, out = _post(server_url, dict(REQ, **bad))
    assert code == 400 and out["error"]


def test_http_errors(server_url, service, monkeypatch):
    """A body that is no JSON object, an unknown path (GET and POST), a server
    fault inside generate_video (500, the server lives on), no text at all
    (400), and the lora fields on a server without --lora-dir."""
    code, out = _post(server_url, None, raw=b"[1, 2]")
    assert code == 400 and "JSON object" in out["error"]
    code, out = _post(server_url, None, raw=b"{nope")
    assert code == 400 and "not valid JSON" in out["error"]
    for send in (lambda: urllib.request.urlopen(server_url + "/nope"), lambda: _post(server_url, {}, path="/nope")):
        try:
            result = send()
            code = result[0] if isinstance(result, tuple) else result.status
        except urllib.error.HTTPError as e:
            code = e.code
        assert code == 404

    def boom(*a, **k):
        raise ValueError("server-side fault")

    monkeypatch.setattr(tgen, "generate_video", boom)
    code, out = _post(server_url, dict(REQ))
    assert code == 500 and out["error"] == "ValueError: server-side fault"
    monkeypatch.undo()
    saved, service.default_text = service.default_text, None
    try:
        code, out = _post(server_url, dict(REQ))
        assert code == 400 and "embeddings" in out["error"]
    finally:
        service.default_text = saved
    code, out = _post(server_url, dict(REQ, lora="style.safetensors"))
    assert code == 400 and "--lora-dir" in out["error"]
    with urllib.request.urlopen(server_url + "/healthz") as r:
        assert json.loads(r.read())["status"] == "ok"


# --- TestDynamicBatching ---

@pytest.fixture(scope="module")
def batch_service(parts, tmp_path_factory):  # noqa: F811
    return _service(parts, tmp_path_factory.mktemp("serve_batch"), max_batch=3, batch_window=1.0)


def test_concurrent_same_shape_requests_coalesce(batch_service, monkeypatch, parts, tmp_path):  # noqa: F811
    """Three concurrent requests: at least two share one batched run, each
    gets its own video, and a coalesced video equals its single run."""
    lat = _Latents(monkeypatch, tgen)
    httpd, url = _start(batch_service)
    try:
        results = [None] * 3

        def post(i):
            results[i] = _post(url, dict(REQ, seed=10 + i))

        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert all(code == 200 for code, _ in results), results
        assert len({out["path"] for _, out in results}) == 3
        batched = [out["batched"] for _, out in results]
        assert max(batched) >= 2 and batch_service.batches_run >= 1
        code, out = _post(url, dict(REQ, num_frames=17, seed=1))  # another shape: alone
        assert code == 200 and out["batched"] == 1
        code, out = _post(url, dict(REQ, pipeline="dev"))
        assert code == 400 and "distilled" in out["error"]
    finally:
        httpd.shutdown()
    at = next(i for i, x in enumerate(lat.seen) if x.shape[0] >= 2)
    group, seeds = lat.seen[at], lat.seeds[at]
    single = _service(parts, tmp_path, 60)
    for i, seed in enumerate(seeds):
        single.generate(dict(REQ, seed=seed))
        np.testing.assert_allclose(group[i : i + 1], lat.seen[-1], rtol=2e-4, atol=1e-5)


def test_coalescing_is_first_come_first_served(batch_service):
    """[A, B, A'] queued at once: A and A' run as one batch of 2, then B."""
    items = [{"req": dict(REQ, **kw), "done": threading.Event(), "result": None, "error": None}
             for kw in (dict(seed=101), dict(num_frames=17, seed=102), dict(seed=103))]
    with batch_service._cv:
        batch_service._pending.extend(items)
        batch_service._cv.notify_all()
    for it in items:
        assert it["done"].wait(timeout=600) and it["error"] is None, it["error"]
    assert [it["result"]["batched"] for it in items] == [2, 1, 2]


def test_batch_worker_survives_a_failed_group(batch_service):
    """A request that fails inside the worker reaches its caller, and the
    worker serves the next one."""
    with pytest.raises(ValueError, match="stage1_steps"):
        batch_service.generate(dict(REQ, stage1_steps=99, seed=1))
    assert batch_service.generate(dict(REQ, seed=2))["batched"] == 1


# --- runtime LoRA ---

def _forward(model, seed: int = 70):
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(1, 8, 16)).astype(np.float32)
    ctx = rng.normal(size=(1, 8, 48)).astype(np.float32)
    pos = create_position_grid(1, 2, 2, 2)
    ts = np.full((1, 1), 0.7, np.float32)
    if isinstance(model, dict):
        return np.asarray(jm.ltx_apply(model, JCFG, jm.Modality(jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(ctx),
                                                                   jnp.asarray(pos)))[0])
    with torch.no_grad():
        return tm.ltx_apply(model, TCFG, tm.Modality(*(torch.from_numpy(x) for x in (lat, ts, ctx, pos))))[0].numpy()


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(np.asarray(b, np.float64)))


def _tensors(model) -> dict:
    return {id(t): t for t in (*model.parameters(), *model.buffers())}


@pytest.mark.parametrize("q4", [False, True])
def test_attach_runtime_lora_matches_jax(tmp_path, capsys, q4):
    """Two adapters (strengths 0.7 and 1.3; the second on layer 1 alone)
    over a dense or a 4-bit base: JAX's counts, factors (the second one
    concatenated by rank) and forward; the base untouched and shared; the
    added memory the factors alone; a dense base against the merge."""
    first, second = _adapter(tmp_path / "a.safetensors", 63), _adapter(tmp_path / "b.safetensors", 64, rank=2,
                                                                       layers=(1,))
    specs = [(first, 0.7), (second, 1.3)]
    base = _dit(65)
    jtree = _jax_dit(base)
    if q4:
        jtree = jquant.quantize_dit_params(jtree, bits=4)
        quantize_dit_params(base, bits=4)
    before = {k: v.clone() for k, v in base.state_dict().items()}
    ref = jlora.attach_runtime_lora(jtree, [jlora.LoraSpec(p, s) for p, s in specs], JCFG, verbose=True)
    ref_out = capsys.readouterr().out
    view = tlora.attach_runtime_lora(base, [tlora.LoraSpec(p, s) for p, s in specs], TCFG, verbose=True)
    assert capsys.readouterr().out == ref_out
    for i in (0, 1):
        for lin in ("to_q", "to_k", "to_v", "to_out"):
            for attn in ("attn1", "attn2"):
                layer, node = getattr(getattr(view.blocks[i], attn), lin), ref["blocks"][attn][lin]
                r = layer.lora_A.shape[0]
                ja, jb = np.asarray(node["lora_A"])[i], np.asarray(node["lora_B"])[i]
                np.testing.assert_array_equal(layer.lora_A.numpy(), ja[:r])
                np.testing.assert_array_equal(layer.lora_B.numpy(), jb[:, :r])
                assert not ja[r:].any() and not jb[:, r:].any()  # JAX's zero factors where layer 0 has none
                assert float(layer.lora_scale) == 1.0 and r == (6 if i == 1 else 4)
                assert getattr(getattr(getattr(base.blocks[i], attn), lin), "lora_A", None) is None
    got, want = _forward(view), _forward(ref)
    if q4:  # the quantized DiT bar of tests/test_torch_port_quant.py (the 4-bit products differ in order)
        assert np.abs(got - want).max() <= 5e-4 * np.abs(want).max()
    else:
        assert _rel(got, want) <= 1e-5
    for k, v in base.state_dict().items():
        assert torch.equal(v, before[k]), k
    shared, mine = _tensors(base), _tensors(view)
    assert set(shared) <= set(mine)
    added = sum(t.numel() * t.element_size() for key, t in mine.items() if key not in shared)
    d = TCFG.inner_dim  # 16 linears at rank 4, then 8 of them at rank 6, fp32; a scale each
    assert added == 8 * 4 * (2 * 4 * d) + 8 * 4 * (2 * 6 * d) + 16 * 4
    if not q4:
        merged = tlora.merge_lora_into_params(base, [tlora.LoraSpec(p, s) for p, s in specs])
        assert _rel(_forward(view), _forward(merged)) <= 1e-5


def test_slots_add_nothing_and_the_slot_attach_equals_the_plain_one(tmp_path):
    """Rank-4 slots (B = 0) leave the forward bitwise; a rank-2 adapter in
    the slots (zero-padded, scale 1) equals the attach without slots;
    past the slot rank, or on a linear without a slot, it raises."""
    adapter = _adapter(tmp_path / "a.safetensors", 66, rank=2, layers=(0,))
    base = _dit(67)
    plain_out = _forward(base)
    slotted = tlora.inject_lora(_dit(67), TCFG, tlora.LoRAConfig(rank=4), torch.Generator().manual_seed(0))
    assert np.array_equal(_forward(slotted), plain_out)
    spec = [tlora.LoraSpec(adapter, 0.9)]
    view = tlora.attach_runtime_lora(slotted, spec, TCFG, slot_rank=4)
    plain = tlora.attach_runtime_lora(base, spec, TCFG)
    layer, d = view.blocks[0].attn1.to_q, TCFG.inner_dim
    assert layer.lora_A.shape == (4, d) and layer.lora_B.shape == (d, 4) and float(layer.lora_scale) == 1.0
    assert torch.equal(layer.lora_A[2:], torch.zeros(2, d)) and torch.equal(layer.lora_B[:, 2:], torch.zeros(d, 2))
    assert float(slotted.blocks[0].attn1.to_q.lora_scale) == 4.0  # the base keeps its slot
    np.testing.assert_allclose(_forward(view), _forward(plain), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="exceeds the slot rank 1"):
        tlora.attach_runtime_lora(tlora.inject_lora(_dit(67), TCFG, tlora.LoRAConfig(rank=1),
                                                    torch.Generator().manual_seed(0)), spec, TCFG, slot_rank=1)
    with pytest.raises(ValueError, match="has no rank-4 adapter slot"):
        tlora.attach_runtime_lora(base, spec, TCFG, slot_rank=4)


def test_attaching_over_slots_without_slot_mode_keeps_the_strength(tmp_path):
    """The JAX function's slot-scale defect, not copied: attaching without
    slots over a rank-4 slotted base (scale alpha / rank = 4) applies the
    adapter at its own strength, as over the unslotted base, not 4 times it."""
    adapter = _adapter(tmp_path / "a.safetensors", 68, rank=2, layers=(0,))
    spec = [tlora.LoraSpec(adapter, 1.0)]
    over_plain = _forward(tlora.attach_runtime_lora(_dit(69), spec, TCFG))
    slotted = tlora.inject_lora(_dit(69), TCFG, tlora.LoRAConfig(rank=4), torch.Generator().manual_seed(0))
    over_slots = tlora.attach_runtime_lora(slotted, spec, TCFG)
    assert over_slots.blocks[0].attn1.to_q.lora_A.shape == (6, TCFG.inner_dim)
    np.testing.assert_allclose(_forward(over_slots), over_plain, rtol=1e-6, atol=1e-6)
    jtree = jlora.inject_lora(_jax_dit(_dit(69)), JCFG, jlora.LoRAConfig(rank=4), jax.random.key(0))
    jax_out = _forward(jlora.attach_runtime_lora(jtree, [jlora.LoraSpec(adapter, 1.0)], JCFG))
    assert _rel(jax_out, over_plain) > 1e-3  # JAX's result: the adapter at 4x


# --- TestServeLoRA and TestLoraSlotServing ---

@pytest.fixture()
def lora_service(parts, tmp_path):  # noqa: F811
    lora_dir = tmp_path / "adapters"
    lora_dir.mkdir()
    _adapter(lora_dir / "style.safetensors", 71)
    return _service(parts, tmp_path / "out", seed=72, lora_dir=lora_dir, lora_cache=2)


def test_lora_changes_output_shares_the_base_and_caches(lora_service, monkeypatch):
    lat = _Latents(monkeypatch, tgen)
    lora_service.generate(dict(REQ, seed=3))
    lora_service.generate(dict(REQ, seed=3, lora="style.safetensors"))
    assert not np.array_equal(lat.seen[0], lat.seen[1])
    key = (("style.safetensors", 1.0),)
    cached = lora_service._lora_cache[key]
    assert lora_service._transformer_for(key) is cached  # the second request hits the LRU
    base = lora_service.models.transformer
    assert cached.blocks[0].attn1.to_q.weight is base.blocks[0].attn1.to_q.weight
    assert cached.video.patchify_proj.weight is base.video.patchify_proj.weight
    assert cached.blocks[0].attn1.to_q.lora_A is not None and getattr(base.blocks[0].attn1.to_q, "lora_A", None) is None
    lora_service.generate(dict(REQ, seed=3))
    assert np.array_equal(lat.seen[2], lat.seen[0])  # the base is unchanged


def test_lora_lru_eviction_and_batch_key(lora_service):
    import shutil

    d = lora_service.lora_dir
    for name in ("b.safetensors", "c.safetensors"):
        shutil.copy(d / "style.safetensors", d / name)
    for name in ("style.safetensors", "b.safetensors", "c.safetensors"):
        lora_service._transformer_for(lora_service._lora_key({"lora": name}))
    assert len(lora_service._lora_cache) == 2 and (("style.safetensors", 1.0),) not in lora_service._lora_cache
    plain, withl = lora_service._batch_key(dict(REQ)), lora_service._batch_key(dict(REQ, lora="style.safetensors"))
    strong = lora_service._batch_key(dict(REQ, lora="style.safetensors", lora_strength=2.0))
    assert len({plain, withl, strong}) == 3
    assert lora_service._batch_key(dict(REQ, height=64.0)) == plain  # coerced fields


def test_slot_serving(parts, tmp_path, monkeypatch):  # noqa: F811
    """--lora-slot-rank 4 with a rank-2 adapter: the base request is bitwise
    the unslotted base's, the adapted one differs, its view keeps the slot
    shapes and dtype; an adapter past the slot rank falls back to the plain
    attach."""
    lora_dir = tmp_path / "adapters"
    lora_dir.mkdir()
    _adapter(lora_dir / "style.safetensors", 73, rank=2, layers=(0,))
    _adapter(lora_dir / "wide.safetensors", 74, rank=8, layers=(0,))
    lat = _Latents(monkeypatch, tgen)
    _service(parts, tmp_path / "plain", seed=75).generate(dict(REQ, seed=3))
    slot = _service(parts, tmp_path / "slot", seed=75, lora_dir=lora_dir, lora_slot_rank=4)
    slot.generate(dict(REQ, seed=3))
    slot.generate(dict(REQ, seed=3, lora="style.safetensors"))
    assert np.array_equal(lat.seen[1], lat.seen[0]) and not np.array_equal(lat.seen[2], lat.seen[0])
    view = next(iter(slot._lora_cache.values()))
    base_shapes = {k: (v.shape, v.dtype) for k, v in slot.models.transformer.state_dict().items()}
    assert {k: (v.shape, v.dtype) for k, v in view.state_dict().items()} == base_shapes
    slot.generate(dict(REQ, seed=3, lora="wide.safetensors"))
    wide = slot._lora_cache[(("wide.safetensors", 1.0),)]
    assert wide.blocks[0].attn1.to_q.lora_A.shape == (12, TCFG.inner_dim)


# --- TestServeStreaming ---

def _stream(url, req):
    r = urllib.request.Request(url + "/generate", json.dumps(dict(req, stream=True)).encode(),
                               {"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=600) as resp:
        assert resp.status == 200 and resp.headers["Content-Type"] == "application/x-ndjson"
        return [json.loads(line) for line in resp.read().decode().splitlines()]


def test_stream_events_then_result(server_url):
    lines = _stream(server_url, dict(REQ, stage1_steps=2, seed=5))
    kinds = [line["kind"] for line in lines]
    assert kinds[-1] == "result" and set(lines[-1]) == KEYS | {"kind"}
    steps = [(e["step"], e["total"]) for e in lines if e["kind"] == "denoise_step"]
    assert steps == [(1, 2), (2, 2), (1, 1)]
    assert [e["phase"] for e in lines if e["kind"] == "phase"] == ["stage1_denoise", "upsample", "stage2_denoise",
                                                                   "vae_decode"]
    previews = [e for e in lines if e["kind"] == "preview"]
    assert previews and previews[-1]["frame"] == 8
    jpeg = base64.b64decode(previews[-1]["jpeg_b64"])
    assert jpeg[:3] == b"\xff\xd8\xff" and Image.open(io.BytesIO(jpeg)).size == (64, 64)
    assert [e["current"] for e in lines if e["kind"] == "progress"] == [9]
    assert not profiling.has_event_sinks()  # the sink left with its request


def test_stream_rejected_in_batch_mode_and_errors_arrive_as_events(server_url, service):
    service.max_batch = 2
    try:
        with pytest.raises(tserve.RequestError, match="streaming requires"):
            service.validate_streaming(dict(REQ))
    finally:
        service.max_batch = 1
    lines = _stream(server_url, dict(REQ, stage1_steps=99))
    assert lines[-1]["kind"] == "error" and "stage1_steps" in lines[-1]["error"]


# --- TestServeEnhance ---

class _StubTextEncoder:
    """Text-encoder stand-in: deterministic embeddings and marked enhancement
    (tests/test_serve.py's, with torch tensors)."""

    def __init__(self, caption_channels):
        self.caption_channels = caption_channels
        self.encoded = []
        self.grad_enabled = []

    def encode(self, prompt):
        self.encoded.append(prompt)
        self.grad_enabled.append(torch.is_grad_enabled())
        rng = np.random.default_rng(sum(map(ord, prompt)))
        return torch.from_numpy(rng.normal(size=(1, 8, self.caption_channels)).astype(np.float32)), None

    def enhance_t2v(self, prompt, **kw):
        return f"{prompt}, cinematic lighting (t2v max={kw.get('max_new_tokens')})"

    def enhance_i2v(self, prompt, **kw):
        return f"{prompt} (i2v)"

    def enhance_negative(self, prompt, negative="", **kw):
        return f"{negative} blurry"


def _enhance_service(parts, tmp_path, **kw):  # noqa: F811
    port, _ = _bundles(parts, _dit(76))
    return tserve.GenerationService(port, text_encoder=_StubTextEncoder(48), output_dir=tmp_path,
                                    dtype=torch.float32, **kw)


def test_enhance_modes_validation_and_http(parts, tmp_path, service):  # noqa: F811
    svc = _enhance_service(parts, tmp_path)
    out = svc.enhance({"prompt": "a cat", "max_tokens": 99})
    assert out["enhanced"] == "a cat, cinematic lighting (t2v max=99)" and out["mode"] == "t2v"
    assert set(out) == {"prompt", "enhanced", "mode", "wall_seconds"}
    assert svc.enhance({"prompt": "a cat", "mode": "i2v"})["enhanced"] == "a cat (i2v)"
    assert svc.enhance({"prompt": "a cat", "mode": "negative", "negative_prompt": "ugly"})["enhanced"] == "ugly blurry"
    with pytest.raises(tserve.RequestError, match="prompt is required"):
        svc.enhance({})
    with pytest.raises(tserve.RequestError, match="mode must be"):
        svc.enhance({"prompt": "x", "mode": "bogus"})
    with pytest.raises(tserve.RequestError, match="text encoder"):
        service.enhance({"prompt": "x"})
    httpd, url = _start(svc)
    try:
        code, body = _post(url, {"prompt": "a dog"}, path="/enhance")
        assert code == 200 and "cinematic" in body["enhanced"]
        code, body = _post(url, {}, path="/enhance")
        assert code == 400 and "prompt is required" in body["error"]
    finally:
        httpd.shutdown()


def test_generate_with_enhance_prompt_alone_and_batched(parts, tmp_path):  # noqa: F811
    """The enhanced prompt conditions the video and comes back, in the
    unbatched and the batched path alike; text encodes run with grad off in
    the serving threads."""
    svc = _enhance_service(parts, tmp_path / "one")
    out = svc.generate(dict(REQ, seed=2, enhance_prompt=True))
    assert out["enhanced_prompt"].startswith("a cat, cinematic") and svc.text_encoder.encoded[0] == out["enhanced_prompt"]
    batched = _enhance_service(parts, tmp_path / "two", max_batch=2, batch_window=2.0)
    results = {}

    def run(name, prompt, seed):
        results[name] = batched.generate(dict(REQ, prompt=prompt, seed=seed, enhance_prompt=True))

    threads = [threading.Thread(target=run, args=a) for a in (("a", "a cat", 1), ("b", "a dog", 2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert results["a"]["batched"] == results["b"]["batched"] == 2
    assert results["a"]["enhanced_prompt"].startswith("a cat, cinematic")
    assert results["b"]["enhanced_prompt"].startswith("a dog, cinematic")
    assert not any(svc.text_encoder.grad_enabled + batched.text_encoder.grad_enabled)


# --- main ---

def _tiny_bundle(parts):  # noqa: F811
    return _bundles(parts, _dit(77))[0]


def test_main_loads_warms_up_and_serves(parts, tmp_path, monkeypatch):  # noqa: F811
    """main() over a snapshot directory (the loader patched to the narrow
    bundle), --embeddings, --warmup, port 0, --device cpu: one warm
    request, then /healthz and /generate over HTTP."""
    emb = tmp_path / "emb.safetensors"
    save_safetensors(emb, {"video_prompt_embeds": parts["ctx"][0]})
    calls = []
    monkeypatch.setattr(loading, "load_model_bundle", lambda *a, **kw: calls.append(kw) or _tiny_bundle(parts))
    seen = {}

    def ready(httpd, svc):
        def drive():
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            with urllib.request.urlopen(url + "/healthz") as r:
                seen["health"] = json.loads(r.read())
            seen["generate"] = _post(url, dict(REQ, seed=4))
            httpd.shutdown()

        threading.Thread(target=drive, daemon=True).start()

    tserve.main(["--model-repo", str(tmp_path), "--embeddings", str(emb), "--port", "0", "--warmup", "64x64x9",
                 "--output-dir", str(tmp_path / "out"), "--device", "cpu"], ready=ready)
    assert calls[0]["device"] == torch.device("cpu") and calls[0]["pipeline"] == "distilled"
    assert seen["health"]["requests_served"] == 1  # the warm request
    code, out = seen["generate"]
    assert code == 200 and out["requests_served"] == 2 and out["path"].startswith(str(tmp_path / "out"))


@pytest.mark.parametrize("flag", [["--mesh", "1,1,8"], ["--pipeline-parallel", "2"], ["--pipeline-tensor", "2"],
                                  ["--sequence-parallel"], ["--aux-park"]])
def test_main_refuses_the_unported_flags_by_name(flag, monkeypatch):
    """No flag is refused: a mesh or stages of more than one rank with no
    launcher exit naming torchrun before any weight loads, and --aux-park
    reaches the service (its load patched out here)."""
    assert not hasattr(tserve, "_REFUSED") and not hasattr(tserve, "refused_flags")
    if flag[0] in ("--sequence-parallel", "--pipeline-tensor"):  # they take effect with --mesh / stages
        return
    if flag[0] == "--aux-park":
        seen = []
        monkeypatch.setattr(tserve, "load_service", lambda args: seen.append(args.aux_park) or _NoService())
        monkeypatch.setattr(tserve, "_serve", lambda *a: None)
        tserve.main(["--model-repo", "x", *flag, "--device", "cpu"])
        assert seen == [True]
        return
    with pytest.raises(SystemExit) as info:
        tserve.main(["--model-repo", "x", *flag, "--device", "cpu"])
    msg = str(info.value)
    assert flag[0] in msg and "torchrun" in msg


class _NoService:
    def close(self):
        pass


def test_main_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tserve.main(["--model-repo", "x"])
