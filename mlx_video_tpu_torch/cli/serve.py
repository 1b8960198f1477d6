"""``python -m mlx_video_tpu_torch.serve``: the resident generation server.
Models load once and stay on the card; every request reuses them.

Counterpart of mlx_video_tpu/cli/serve.py on the same HTTP surface, request
fields and flags, plus ``--device`` (default ``cuda``; the CPU takes
``--device cpu``):

  GET  /healthz            -> {"status": "ok", "requests_served", "batches_run", ...}
  POST /generate {json}    -> {"path", "paths", "wall_seconds", "phases", "requests_served", "batched"}
  POST /generate {"stream": true, ...} -> NDJSON: one line a denoise_step /
       phase / progress / preview (base64 JPEG of the latest decoded frame)
       event, then {"kind": "result", ...} or {"kind": "error", ...}
       (needs --max-batch 1)
  POST /enhance {prompt, mode?, negative_prompt?, max_tokens?, temperature?}
       -> {"prompt", "enhanced", "mode", "wall_seconds"} (needs a text encoder)

Request fields (all optional but ``prompt`` without ``--embeddings``):
prompt, negative_prompt, height, width, num_frames, fps, seed, num_videos,
pipeline (must be the loaded one), stage1_steps, stage2_steps,
num_inference_steps, cfg_scale, cfg_cache_interval, attn_broadcast_interval,
teacache_threshold, cfg_sequential, audio, audio_mode, tiling,
enhance_prompt, enhance_max_tokens, enhance_temperature, lora (adapter file
name(s) under --lora-dir), lora_strength (a number or one a name).
``low_memory`` is refused (400): a resident server keeps its models.

Generation is serialised by a lock (one card). With ``--max-batch N`` a
worker thread coalesces queued requests whose coerced fields, negative
prompt and adapters agree into one batched ``generate_video`` (per-request
prompts and seeds), first come first served. Adapters attach at run time
over the shared base (lora.py:attach_runtime_lora; an LRU of
``--lora-cache`` adapted views, each costing its factors alone), or replace
zero-effect slots of ``--lora-slot-rank`` on the base. Every generation and
enhancement runs under ``torch.inference_mode()`` in the thread that serves
it (grad mode is thread-local).

Sharded serving, under ``torchrun --nproc-per-node N -m
mlx_video_tpu_torch.serve``: ``--mesh d,f,t`` (``--sequence-parallel``) or
``--pipeline-parallel P`` (``--pipeline-tensor T``), as the generate CLI
takes them. The models are sharded (or staged) once, at load, and so is the
text encoder under ``--mesh``; a request never re-slices them, and adapters
attach over the sharded base (each rank keeps its slices of the factors).
JAX's server is one controller over all devices; here every rank is a
process, so:

- rank 0 alone serves HTTP, validates (a 400 is rank 0's alone), coalesces
  and keeps the adapter LRU;
- for each unit of work it runs (one request, a coalesced group, an
  enhancement) it first publishes one message to the other ranks
  (parallel/distributed.py:WorkChannel: the requests' JSON fields, from
  which every rank derives the same adapter key and seeds; the text comes
  from each rank's own encoder or ``--embeddings``), then runs the unit;
- every other rank runs the same unit (the same ``generate_video``, the
  same encoder calls); every rank reports its outcome and waits for all
  the reports (bounded) before the next unit; rank 0 answers 500 if any
  rank failed; only rank 0 writes files, streams events and answers;
- a rank that fails inside a unit leaves the others at a collective: a
  failure report cancels their collectives (each rank watches the reports
  while it runs its part), and after a failed unit every rank renews the
  mesh's process groups, so the server goes on serving;
- when rank 0 stops serving it publishes a stop message, and the others
  leave their loop and the process group.

Refused by name: ``--aux-park`` (a 16 GB accelerator's memory plan, left out
of the port). Differences from the JAX server, on purpose: ``--warmup`` runs
one warm request (the port compiles no per-shape program, so the JAX
server's second, streamed warm request has nothing to warm); the default
output directory is under the temporary directory (``$TMPDIR``).

    python -m mlx_video_tpu_torch.serve --model-repo SNAPSHOT --embeddings emb.safetensors \\
        --port 8787 --warmup 512x512x33
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import torch

_PIPELINES = ("distilled", "dev")

# The JAX server's options that the port refuses, with why.
_REFUSED = {
    "aux_park": "a 16 GB accelerator's memory plan, left out of the port (ROADMAP 'Leave out')",
}


class RequestError(ValueError):
    """A client's mistake: HTTP 400 (server faults stay 500)."""


class GenerationService:
    """Owns the resident models and serialises the requests."""

    def __init__(
        self,
        models,
        text_encoder=None,
        default_text=None,
        output_dir: Optional[Path] = None,
        dtype=torch.bfloat16,
        loaded_pipeline: str = "distilled",
        max_batch: int = 1,
        batch_window: float = 0.05,
        lora_dir: Optional[Path] = None,
        lora_cache: int = 4,
        lora_slot_rank: int = 0,
        mesh=None,
        sequence_parallel: bool = False,
        pipeline_parallel: int = 0,
        pipeline_tensor: int = 1,
        channel=None,
    ) -> None:
        self.models = models
        # sharded serving: the options every generate_video takes, and rank
        # 0's channel to the other ranks (None in one process)
        self.mesh, self.sequence_parallel = mesh, bool(sequence_parallel)
        self.pipeline_parallel, self.pipeline_tensor = int(pipeline_parallel), int(pipeline_tensor)
        self.channel = channel
        self.lora_dir = Path(lora_dir).resolve() if lora_dir else None
        self.lora_cache_size = max(1, int(lora_cache))
        self._lora_cache: dict = {}  # key -> adapted transformer view (LRU by insertion)
        self.lora_slot_rank = int(lora_slot_rank)
        if self.lora_slot_rank and self.lora_dir and models is not None:
            from mlx_video_tpu_torch.lora import LoRAConfig, inject_lora

            device = models.transformer.video.scale_shift_table.device
            # zero-effect slots (B = 0) in the serving dtype
            inject_lora(models.transformer, models.transformer_config, LoRAConfig(rank=self.lora_slot_rank),
                        torch.Generator(device=device).manual_seed(0), dtype=dtype)
        self.text_encoder = text_encoder
        self.default_text = default_text
        self.output_dir = Path(output_dir if output_dir is not None
                               else Path(tempfile.gettempdir()) / "mlx_video_tpu_torch_serve")
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.dtype = dtype
        self.loaded_pipeline = loaded_pipeline
        self.lock = threading.Lock()
        self.requests_served = 0
        self.batches_run = 0
        self.started = time.time()
        self.max_batch = max(1, int(max_batch))
        self.batch_window = float(batch_window)
        self._pending: list = []
        self._cv = threading.Condition()
        if self.max_batch > 1:
            threading.Thread(target=self._batch_worker, daemon=True).start()

    def _text_for(self, req: dict):
        from mlx_video_tpu_torch.pipelines.generate import TextConditioning

        prompt = req.get("prompt", "")
        if self.text_encoder is not None:
            if req.get("enhance_prompt"):
                prompt = self.text_encoder.enhance_t2v(
                    prompt, max_new_tokens=int(req.get("enhance_max_tokens", 512)),
                    temperature=float(req.get("enhance_temperature", 0.7)),
                )
                req["_enhanced_prompt"] = prompt
            video, audio = self.text_encoder.encode(prompt)
            neg = req.get("negative_prompt")
            video_neg = audio_neg = None
            if neg:
                video_neg, audio_neg = self.text_encoder.encode(neg)
            return TextConditioning(video_embeddings=video, video_neg_embeddings=video_neg, audio_embeddings=audio,
                                    audio_neg_embeddings=audio_neg)
        if self.default_text is None:
            raise RequestError(
                "This server has no text encoder loaded; it can only serve requests against its --embeddings "
                "default (start the server with --embeddings or a text-encoder snapshot)."
            )
        return self.default_text

    def _validate(self, req: dict) -> None:
        pipeline = str(req.get("pipeline", self.loaded_pipeline)).lower()
        if pipeline not in _PIPELINES:
            raise RequestError(f"pipeline must be one of {_PIPELINES}")
        if pipeline != self.loaded_pipeline:
            raise RequestError(f"this server loaded {self.loaded_pipeline!r} weights; start a server with "
                               f"--pipeline {pipeline} for that schedule")
        if req.get("low_memory"):
            raise RequestError("low_memory is not served: it frees the transformer after each run, defeating a "
                               "resident server — shard with --mesh instead")
        if req.get("enhance_prompt") and self.text_encoder is None:
            raise RequestError("enhance_prompt needs a text encoder; this server runs on precomputed --embeddings")
        try:  # a malformed but plausible field is a 400, not a 500 deep inside generation
            kw = self._kwargs_for(req)
        except (TypeError, ValueError) as e:
            raise RequestError(f"bad request field: {e}")
        tc = kw["teacache_threshold"] > 0.0
        pab = kw["attn_broadcast_interval"] > 1
        cc = kw["cfg_cache_interval"] > 1
        if tc and (pab or cc):
            raise RequestError("teacache_threshold cannot be combined with cfg_cache_interval or "
                               "attn_broadcast_interval (one caching dial at a time)")
        if pab and cc:
            raise RequestError("attn_broadcast_interval and cfg_cache_interval cannot be combined")
        if kw["cfg_sequential"] and (tc or pab or cc):
            raise RequestError("cfg_sequential cannot be combined with cfg_cache_interval, attn_broadcast_interval, "
                               "or teacache_threshold (the caching dials assume the batched-CFG forward shape)")
        audio_mode = kw["audio_mode"]
        if audio_mode == "auto":  # generate_video's rule
            audio_mode = "separate" if self.loaded_pipeline == "distilled" else "joint"
        if kw["audio"] and audio_mode == "joint" and (tc or pab or cc):
            raise RequestError("the caching dials (teacache_threshold, cfg_cache_interval, attn_broadcast_interval) "
                               "support the video-only denoise; use audio_mode=separate to combine them with audio")
        if (tc or pab) and (self.sequence_parallel or self.pipeline_parallel):
            raise RequestError("teacache_threshold/attn_broadcast_interval do not compose with this server's "
                               "sequence/pipeline parallelism")
        self._lora_key(req)

    def _lora_key(self, req: dict):
        """The request's adapters as a cache key ((name, strength), ...), ()
        for the base; computed once and kept on the request."""
        if "_lora_key" in req:
            return req["_lora_key"]
        sel = req.get("lora")
        if not sel:
            req["_lora_key"] = ()
            return ()
        if self.lora_dir is None:
            raise RequestError("this server has no adapter directory; start it with --lora-dir to serve "
                               "per-request LoRA")
        if isinstance(sel, str):
            names = [sel]
        elif isinstance(sel, list) and all(isinstance(n, str) for n in sel):
            names = list(sel)
        else:
            raise RequestError("lora must be a file name or a list of file names")
        strength = req.get("lora_strength", 1.0)
        if isinstance(strength, bool) or not isinstance(strength, (int, float, list)):
            raise RequestError("lora_strength must be a number or a list of numbers")
        if isinstance(strength, list):
            if not all(isinstance(s, (int, float)) and not isinstance(s, bool) for s in strength):
                raise RequestError("lora_strength must be a number or a list of numbers")
            strengths = [float(s) for s in strength]
        else:
            strengths = [float(strength)] * len(names)
        if len(strengths) != len(names):
            raise RequestError("lora_strength list must match lora list length")
        key = []
        for name, s in zip(names, strengths):
            p = (self.lora_dir / str(name)).resolve()
            if self.lora_dir not in p.parents and p != self.lora_dir:
                raise RequestError(f"lora {name!r} escapes the adapter directory")
            if not p.is_file():
                raise RequestError(f"lora {name!r} not found under the adapter directory")
            key.append((str(p.relative_to(self.lora_dir)), s))
        req["_lora_key"] = tuple(key)
        return req["_lora_key"]

    def _transformer_for(self, key):
        """The base transformer for (), else the LRU-cached adapted view."""
        if not key:
            return self.models.transformer
        if key in self._lora_cache:
            self._lora_cache[key] = self._lora_cache.pop(key)  # most recently used last
            return self._lora_cache[key]
        from mlx_video_tpu_torch.lora import LoraSpec, attach_runtime_lora

        specs = [LoraSpec(self.lora_dir / name, s) for name, s in key]
        base, config = self.models.transformer, self.models.transformer_config
        if self.lora_slot_rank:
            try:
                attached = attach_runtime_lora(base, specs, config, slot_rank=self.lora_slot_rank)
            except ValueError as e:
                print(f"[serve] LoRA slots unusable for {key}: {e}; attaching without slots", flush=True)
                attached = attach_runtime_lora(base, specs, config)
        else:
            attached = attach_runtime_lora(base, specs, config)
        while len(self._lora_cache) >= self.lora_cache_size:
            self._lora_cache.pop(next(iter(self._lora_cache)))
        self._lora_cache[key] = attached
        return attached

    def _models_for(self, req: dict):
        key = self._lora_key(req)
        if not key:
            return self.models
        return dataclasses.replace(self.models, transformer=self._transformer_for(key))

    def _batch_key(self, req: dict):
        """What shapes and schedules a run: requests that share it can share
        one batched run (prompt and seed stay per request). From the coerced
        fields, so int and float or omitted and default agree."""
        kw = self._kwargs_for(req)
        kw.pop("seed", None)
        return (tuple(sorted((k, repr(v)) for k, v in kw.items())), str(req.get("negative_prompt")),
                self._lora_key(req))

    def enhance(self, req: dict) -> dict:
        """The enhance CLI over HTTP: Gemma chat generation under the
        bundled system prompts."""
        if self.text_encoder is None:
            raise RequestError("this server has no text encoder loaded; /enhance needs one")
        prompt = str(req.get("prompt", ""))
        if not prompt:
            raise RequestError("prompt is required")
        mode = str(req.get("mode", "t2v")).lower()
        if mode not in ("t2v", "i2v", "negative"):
            raise RequestError("mode must be one of t2v, i2v, negative")
        with self.lock, torch.inference_mode():  # the 12B forward is serialised with generation
            t0 = time.time()
            enhanced = self._on_every_rank("enhance", {"req": _public(req)}, lambda: self._enhance(req))
        return {"prompt": prompt, "enhanced": enhanced, "mode": mode, "wall_seconds": round(time.time() - t0, 3)}

    def _enhance(self, req: dict) -> str:
        """The enhanced text of a validated /enhance request."""
        prompt, mode = str(req.get("prompt", "")), str(req.get("mode", "t2v")).lower()
        kw = dict(max_new_tokens=int(req.get("max_tokens", 512)), temperature=float(req.get("temperature", 0.7)))
        if mode == "t2v":
            return self.text_encoder.enhance_t2v(prompt, **kw)
        if mode == "i2v":
            return self.text_encoder.enhance_i2v(prompt, **kw)
        return self.text_encoder.enhance_negative(prompt, str(req.get("negative_prompt", "")), **kw)

    def _on_every_rank(self, op: str, payload: dict, run):
        """``run()`` here and, under a launcher, the same unit on every other
        rank: the message goes out first, and the unit ends when every rank
        has reported (parallel/distributed.py:WorkChannel.run); a failure on
        any rank is a server fault here. Called under the lock."""
        if self.channel is None:
            return run()
        from mlx_video_tpu_torch.parallel.collectives import Cancelled

        out, error, others = self.channel.run(self.channel.publish(dict(payload, op=op)), run)
        if error is not None and not isinstance(error, Cancelled):
            raise error
        if error is not None or others:
            raise RuntimeError(f"the unit failed on another rank ({'; '.join(others)})")
        return out

    def follow(self) -> None:
        """The loop of a rank other than 0: every unit rank 0 publishes, run
        as rank 0 runs it and reported; returns at the stop message."""
        while True:
            seq, msg = self.channel.receive()
            if msg["op"] == "stop":
                self.channel.run(seq, lambda: None)
                return
            with torch.inference_mode():
                _, error, _ = self.channel.run(seq, lambda: self._run_unit(msg))
            if error is not None:  # reported to rank 0, which answers 500
                traceback.print_exception(error)

    def _run_unit(self, msg: dict) -> None:
        op = msg["op"]
        if op == "one":
            self._generate_locked(msg["req"], self._kwargs_for(msg["req"]))
        elif op == "group":
            self._run_group(msg["reqs"])
        elif op == "enhance":
            self._enhance(msg["req"])
        else:
            raise ValueError(f"unknown unit {op!r}")

    def close(self) -> None:
        """Rank 0 under a launcher: the stop message, and wait (bounded)
        until the other ranks have taken it."""
        if self.channel is not None and self.channel.rank == 0:
            with self.lock:
                self.channel.run(self.channel.publish({"op": "stop"}), lambda: None)

    def validate_streaming(self, req: dict) -> None:
        """Everything that must 400 before a streamed 200 header goes out."""
        self._validate(req)
        if self.max_batch > 1:
            raise RequestError("streaming requires --max-batch 1: events cannot be attributed to one request "
                               "inside a coalesced batch")

    def generate_streamed(self, req: dict, sink) -> dict:
        """Generate with ``sink`` subscribed to the event stream for this
        request alone (the lock serialises requests). The caller ran
        :meth:`validate_streaming` before its 200 header."""
        return self._generate_one(req, sink=sink)

    def generate(self, req: dict) -> dict:
        self._validate(req)
        if self.max_batch <= 1:
            return self._generate_one(req)
        item = {"req": req, "done": threading.Event(), "result": None, "error": None}
        with self._cv:
            self._pending.append(item)
            self._cv.notify_all()
        if not item["done"].wait(timeout=3600):  # a dead worker is a server fault, not a hang
            raise RuntimeError("generation batch worker unresponsive")
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def _batch_worker(self) -> None:
        while True:
            try:
                self._batch_worker_once()
            except Exception as e:  # noqa: BLE001 — the worker must survive
                print(f"[serve] batch worker error: {type(e).__name__}: {e}", flush=True)

    def _batch_worker_once(self) -> None:
        """Pop the oldest request, gather up to max_batch - 1 queued ones of
        its batch key within the batch window, and run them."""
        with self._cv:
            while not self._pending:
                self._cv.wait()
            head = self._pending.pop(0)
            hkey = self._batch_key(head["req"])
            group = [head]
            deadline = time.time() + self.batch_window
            while len(group) < self.max_batch:
                for it in list(self._pending):
                    if self._batch_key(it["req"]) == hkey:
                        self._pending.remove(it)
                        group.append(it)
                        if len(group) >= self.max_batch:
                            break
                if len(group) >= self.max_batch:
                    break
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
        try:
            solo = (len(group) == 1 or bool(group[0]["req"].get("audio", False))
                    or int(group[0]["req"].get("num_videos", 1)) != 1)
            if solo:
                for it in group:
                    try:
                        it["result"] = self._generate_one(it["req"])
                    except Exception as e:  # noqa: BLE001
                        it["error"] = e
            else:
                self._generate_group(group)
        except Exception as e:  # noqa: BLE001
            for it in group:
                if it["error"] is None and it["result"] is None:
                    it["error"] = e
        for it in group:
            it["done"].set()

    def _generate_group(self, group: list) -> None:
        """One batched generate_video for N coalesced requests: each prompt
        encoded (serialised) and stacked, each seed through ``seeds``, one
        result path a request."""
        reqs = [it["req"] for it in group]
        with self.lock, torch.inference_mode():
            t0 = time.time()
            result = self._on_every_rank("group", {"reqs": [_public(r) for r in reqs]}, lambda: self._run_group(reqs))
            wall = time.time() - t0
        for i, it in enumerate(group):
            it["result"] = self._response(result.video_paths[i], result, wall, batched=len(group))
            if "_enhanced_prompt" in it["req"]:  # the prompt that conditioned this video
                it["result"]["enhanced_prompt"] = it["req"]["_enhanced_prompt"]

    def _run_group(self, reqs: list):
        """The batched generate_video of :meth:`_generate_group`; returns
        its result."""
        from mlx_video_tpu_torch.pipelines import generate as gen

        kwargs = self._kwargs_for(reqs[0])
        kwargs["num_videos"] = len(reqs)
        kwargs.pop("seed", None)
        texts = [self._text_for(r) for r in reqs]
        if all(t is texts[0] for t in texts):
            text = texts[0]  # the shared --embeddings default: broadcast
        else:
            def cat(field):
                vals = [getattr(t, field) for t in texts]
                return None if any(v is None for v in vals) else torch.cat(list(vals), dim=0)

            text = gen.TextConditioning(video_embeddings=cat("video_embeddings"),
                                        video_neg_embeddings=cat("video_neg_embeddings"))
        out = self.output_dir / f"gen_{int(time.time() * 1000)}_{self.requests_served}_batch.mp4"
        result = gen.generate_video(self._models_for(reqs[0]), text, output_path=out,
                                    seeds=[int(r.get("seed", 0)) for r in reqs], **kwargs, **self._parallel_kwargs())
        self.requests_served += len(reqs)
        self.batches_run += 1
        return result

    def _parallel_kwargs(self) -> dict:
        return dict(mesh=self.mesh, sequence_parallel=self.sequence_parallel,
                    pipeline_parallel=self.pipeline_parallel, pipeline_tensor=self.pipeline_tensor)

    def _kwargs_for(self, req: dict) -> dict:
        pipeline = str(req.get("pipeline", self.loaded_pipeline)).lower()
        return dict(
            height=int(req.get("height", 512)),
            width=int(req.get("width", 512)),
            num_frames=int(req.get("num_frames", 33)),
            fps=float(req.get("fps", 24.0)),
            seed=int(req.get("seed", 0)),
            num_videos=max(1, min(int(req.get("num_videos", 1)), 8)),
            pipeline="dev" if pipeline == "dev" else "distilled",
            stage1_steps=int(req.get("stage1_steps", 8)),
            stage2_steps=int(req.get("stage2_steps", 3)),
            num_inference_steps=int(req.get("num_inference_steps", 40)),
            cfg_cache_interval=int(req.get("cfg_cache_interval", 1)),
            attn_broadcast_interval=int(req.get("attn_broadcast_interval", 1)),
            teacache_threshold=float(req.get("teacache_threshold", 0.0)),
            cfg_sequential=bool(req.get("cfg_sequential", False)),
            cfg_scale=float(req.get("cfg_scale", 4.0)),
            audio=bool(req.get("audio", False)),
            audio_mode=str(req.get("audio_mode", "auto")),
            tiling=str(req.get("tiling", "auto")),
            dtype=self.dtype,
        )

    def _generate_one(self, req: dict, sink=None) -> dict:
        from mlx_video_tpu_torch.utils.profiling import add_event_sink, remove_event_sink

        kwargs = self._kwargs_for(req)
        with self.lock:
            if sink is not None:
                add_event_sink(sink)
            try:
                with torch.inference_mode():
                    return self._on_every_rank("one", {"req": _public(req)}, lambda: self._generate_locked(req, kwargs))
            finally:
                if sink is not None:
                    remove_event_sink(sink)

    def _generate_locked(self, req: dict, kwargs: dict) -> dict:
        from mlx_video_tpu_torch.pipelines import generate as gen

        t0 = time.time()
        text = self._text_for(req)  # a 12B forward with a text encoder: under the lock too
        # the served counter keeps names apart where the clock's ms collide
        out = self.output_dir / f"gen_{int(time.time() * 1000)}_{self.requests_served}_{kwargs['seed']}.mp4"
        result = gen.generate_video(self._models_for(req), text, output_path=out, **kwargs, **self._parallel_kwargs())
        wall = time.time() - t0
        self.requests_served += 1
        resp = self._response(result.video_path or out, result, wall, batched=1,
                              paths=[str(p) for p in result.video_paths] if result.video_paths else None)
        if "_enhanced_prompt" in req:
            resp["enhanced_prompt"] = req["_enhanced_prompt"]
        return resp

    def _response(self, path, result, wall, batched, paths=None) -> dict:
        return {
            "path": str(path),
            "paths": paths,
            "wall_seconds": round(wall, 3),
            "phases": {k: round(v, 3) for k, v in result.phase_seconds.items()},
            "requests_served": self.requests_served,
            "batched": batched,
        }

    def health(self) -> dict:
        return {
            "status": "ok",
            "requests_served": self.requests_served,
            "batches_run": self.batches_run,
            "max_batch": self.max_batch,
            "uptime_seconds": round(time.time() - self.started, 1),
        }


def _public(req: dict) -> dict:
    """A request's client fields (those a rank derives its state from),
    without the server's own bookkeeping (``_lora_key``, ...)."""
    return {k: v for k, v in req.items() if not k.startswith("_")}


def make_handler(service: GenerationService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                self._send(200, service.health())
            else:
                self._send(404, {"error": "unknown path"})

        def _stream_generate(self, req: dict) -> None:
            """NDJSON: one line an event, then a result or error line; the
            400-able checks run before the 200 header."""
            import queue

            service.validate_streaming(req)
            q: queue.Queue = queue.Queue()
            done = object()
            holder: dict = {}

            def run():
                try:
                    holder["result"] = service.generate_streamed(req, q.put)
                except Exception as e:  # noqa: BLE001 — forwarded as an event
                    holder["error"] = e
                finally:
                    q.put(done)

            threading.Thread(target=run, daemon=True).start()
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Connection", "close")  # the body ends when the connection closes
            self.end_headers()
            gone = False
            while True:
                ev = q.get()
                if ev is done:
                    break
                if gone:
                    continue  # drain, so generation never blocks on a dead client
                try:
                    self.wfile.write((json.dumps(ev) + "\n").encode())
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    gone = True
            if "error" in holder:
                err = holder["error"]
                final = {"kind": "error", "error": f"{type(err).__name__}: {err}"}
            else:
                final = {"kind": "result", **holder["result"]}
            if not gone:
                try:
                    self.wfile.write((json.dumps(final) + "\n").encode())
                except (BrokenPipeError, ConnectionResetError):
                    pass

        def do_POST(self):  # noqa: N802
            if self.path not in ("/generate", "/enhance"):
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except ValueError as e:
                    raise RequestError(f"body is not valid JSON: {e}")
                if not isinstance(req, dict):
                    raise RequestError("body must be a JSON object")
                if self.path == "/enhance":
                    self._send(200, service.enhance(req))
                elif req.get("stream"):
                    self._stream_generate(req)
                else:
                    self._send(200, service.generate(req))
            except RequestError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — a server fault answers 500; the server lives on
                import traceback

                traceback.print_exc()  # the stack goes to the server's log, the client gets type and message
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):
            print(f"[serve] {self.address_string()} {fmt % args}", flush=True)

    return Handler


def serve(service: GenerationService, host: str = "127.0.0.1", port: int = 8787):
    """The HTTP server, not yet serving (port 0 picks a free port)."""
    return ThreadingHTTPServer((host, port), make_handler(service))


def base_parser() -> argparse.ArgumentParser:
    """The JAX server's flag surface (mlx_video_tpu/cli/serve.py:build_parser);
    ``--output-dir`` defaults to None, the temporary directory's
    ``mlx_video_tpu_torch_serve``."""
    p = argparse.ArgumentParser(description="Resident LTX-2 generation server")
    p.add_argument("--model-repo", required=True, help="local snapshot path")
    p.add_argument("--text-encoder-path", default=None)
    p.add_argument("--embeddings", default=None,
                   help="precomputed text-embeddings safetensors used for every "
                        "request (skips the text encoder)")
    p.add_argument("--pipeline", choices=_PIPELINES, default="distilled",
                   help="pipeline whose weights to load")
    p.add_argument("--audio", action="store_true")
    p.add_argument("--w8a8", action="store_true")
    p.add_argument("--w4a8", action="store_true")
    p.add_argument("--mesh", default=None, help="data,fsdp,tensor or 'auto'")
    p.add_argument("--pipeline-parallel", type=int, default=0,
                   help="GPipe pipeline stages for every DiT forward "
                        "(parallel/pipeline.py); exclusive with --mesh.")
    p.add_argument("--pipeline-tensor", type=int, default=1)
    p.add_argument("--sequence-parallel", action="store_true",
                   help="With --mesh: ring-attention token sharding over fsdp")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--max-batch", type=int, default=1,
                   help="Dynamic request batching: up to N queued requests "
                        "with identical shapes/schedules coalesce into one "
                        "batched denoise (per-request prompt + seed).")
    p.add_argument("--batch-window", type=float, default=0.05,
                   help="Seconds to wait for same-shape requests to join a "
                        "batch once one is pending.")
    p.add_argument("--lora-dir", default=None,
                   help="Directory of LoRA .safetensors the server may "
                        "attach per request (request fields: lora, "
                        "lora_strength). Adapters attach as runtime leaves "
                        "over the shared base weights - works over "
                        "quantized bases; each cached view costs only the "
                        "adapter factors in HBM.")
    p.add_argument("--lora-cache", type=int, default=4,
                   help="How many adapter-attached transformer views to "
                        "keep resident (LRU).")
    p.add_argument("--warmup", default=None,
                   help="WxHxF to precompile at startup, e.g. 512x512x33 "
                        "(first request then runs at steady-state latency)")
    p.add_argument("--lora-slot-rank", type=int, default=0,
                   help="attach zero-effect rank-N adapter slots to the base so "
                        "LoRA hot-swap reuses ONE compiled denoise program "
                        "(adapters of rank <= N swap as data; 0 = off)")
    p.add_argument("--aux-park", action="store_true",
                   help="single-chip memory plan: park decoder/upsampler/audio "
                        "trees as per-group int8 IN HBM between requests and "
                        "unpark around each decode (required to serve the 19B "
                        "with the full aux stack on one 16 GB chip)")
    return p


def build_parser() -> argparse.ArgumentParser:
    p = base_parser()
    p.description = "Resident LTX-2 generation server (PyTorch, CUDA)"
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; exits when CUDA is absent)")
    return p


def refused_flags(args: argparse.Namespace, parser: argparse.ArgumentParser) -> list:
    """'--flag (what it waits for)' for each refused option given a value
    other than its default."""
    return [f"{action.option_strings[0]} ({_REFUSED[action.dest]})" for action in parser._actions
            if action.dest in _REFUSED and getattr(args, action.dest) != action.default]


def load_service(args) -> GenerationService:
    """Models, text (an encoder or the embeddings) and the service, as the
    flags say. With ``--mesh`` or ``--pipeline-parallel`` this rank joins
    the launcher's group first (cli/generate.py:_parallel_start) and the
    models (and the encoder, under a mesh) are sharded here, once."""
    from mlx_video_tpu_torch import loading
    from mlx_video_tpu_torch.cli.generate import _parallel_start, load_embeddings
    from mlx_video_tpu_torch.parallel import distributed
    from mlx_video_tpu_torch.parallel.collectives import mesh_groups

    device = _parallel_start(args, torch.device(args.device), prog="serve")
    model_path = Path(args.model_repo)
    models = loading.load_model_bundle(model_path, pipeline=args.pipeline, audio=args.audio, dtype=torch.bfloat16,
                                       bits_hint=loading.bits_hint_for(args.model_repo), device=device)
    try:
        loading.quantize_models(models, model_path, w8a8=args.w8a8, w4a8=args.w4a8, repo_hint=str(args.model_repo))
    except ValueError as e:
        raise SystemExit(f"serve: {e}")
    mesh, meshes = None, []  # meshes: what the units' collectives run on
    if args.mesh:
        mesh = loading.mesh_from_flag(args.mesh, device.type)
        loading.shard_models(models, mesh)
        meshes.append(mesh_groups(mesh))
    elif args.pipeline_parallel:
        meshes.append(mesh_groups(loading.stage_models(models, args.pipeline_parallel, tensor=args.pipeline_tensor,
                                                       device_type=device.type)))
    text_encoder = default_text = None
    if args.embeddings:
        default_text = load_embeddings(args.embeddings, device)
    else:
        from mlx_video_tpu_torch.models.ltx.text_encoder import LTX2TextEncoder

        text_encoder = LTX2TextEncoder.load(args.model_repo, args.text_encoder_path or args.model_repo,
                                            dtype=torch.bfloat16, w8a8=args.w8a8, device=device)
        if mesh is not None:
            text_encoder.shard(mesh)
    channel = distributed.WorkChannel(meshes) if distributed.world_size() > 1 else None
    return GenerationService(
        models, text_encoder=text_encoder, default_text=default_text,
        output_dir=Path(args.output_dir) if args.output_dir else None,
        dtype=models.transformer.video.scale_shift_table.dtype,  # the dtype it was loaded in
        loaded_pipeline=args.pipeline,
        max_batch=args.max_batch, batch_window=args.batch_window,
        lora_dir=Path(args.lora_dir) if args.lora_dir else None, lora_cache=args.lora_cache,
        lora_slot_rank=args.lora_slot_rank, mesh=mesh, sequence_parallel=args.sequence_parallel,
        pipeline_parallel=args.pipeline_parallel, pipeline_tensor=args.pipeline_tensor, channel=channel,
    )


def main(argv=None, ready=None) -> None:
    """Parse, load, warm up, serve until the HTTP server is shut down.
    ``ready(httpd, service)``, when given, is called once the server listens
    (before serving). Under a launcher, ranks other than 0 follow rank 0's
    units instead, and every rank leaves the process group at the end."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mesh and args.pipeline_parallel:  # known at parse time: fail before any weight loads
        raise SystemExit("serve: --mesh and --pipeline-parallel are mutually exclusive")
    refused = refused_flags(args, parser)
    if refused:
        raise SystemExit("serve: not ported to mlx_video_tpu_torch: " + "; ".join(refused))
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve: --device cuda but CUDA is not available (pass --device cpu to run on the CPU)")
    try:
        service = load_service(args)
        try:
            _serve(args, service, ready)
        finally:
            service.close()
    finally:
        if args.mesh or args.pipeline_parallel:
            from mlx_video_tpu_torch.parallel.distributed import shutdown

            shutdown()


def _serve(args, service: GenerationService, ready) -> None:
    if service.channel is not None and service.channel.rank != 0:
        service.follow()
        return
    if args.warmup:
        w, h, f = (int(x) for x in args.warmup.lower().split("x"))
        print(f"[serve] warmup {w}x{h}x{f}...", flush=True)
        t0 = time.time()
        service.generate({"prompt": "warmup", "width": w, "height": h, "num_frames": f})
        print(f"[serve] warmup done in {time.time() - t0:.1f}s", flush=True)
    httpd = serve(service, args.host, args.port)
    print(f"[serve] listening on http://{args.host}:{httpd.server_address[1]} (POST /generate, POST /enhance, "
          "GET /healthz)", flush=True)
    if ready is not None:
        ready(httpd, service)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
