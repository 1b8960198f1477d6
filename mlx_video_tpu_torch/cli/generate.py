"""``python -m mlx_video_tpu_torch.generate`` — the video CLI: the distilled
pipeline and its keyframe and IC-LoRA forms, and the dev pipeline.

Counterpart of mlx_video_tpu/cli/generate.py on the same flag names (the
port's own copy of the JAX package's framework-free ``build_parser`` and
``slugify``, as :func:`base_parser` and :func:`slugify`), plus ``--device`` (default
``cuda``; without CUDA it exits rather than run on the CPU, which takes
``--device cpu``). The run loads the snapshot (and a second transformer for
stage 2 from ``--stage2-model-repo``), merges LoRA adapters into the dense
weights (``--lora`` / ``--lora-strength`` into the transformer,
``--distilled-lora`` into the stage-2 transformer, or into a copy of the
transformer that then refines stage 2), optionally runs the transformers
quantized (``--quantization``, ``--w8a8``, ``--w4a8``), encodes the prompt
with the Gemma-3 text encoder (``--text-encoder-path``, bf16, or W8A8 with
``--w8a8``; the dev pipeline and ``--stage2-dev`` also encode
``--negative-prompt`` or the default one) or reads precomputed text
embeddings (``--embeddings``; a ``video_neg`` entry is the negative prompt for
CFG), generates, writes the mp4s (``--stream``: as the decode finalises
frames; ``--num-videos N``: one a video, ``{stem}_{i}.mp4``; ``--save-frames``:
also PNG frames) and, with ``--profile-json-path``, the phase seconds.
``--pipeline dev`` runs the dev pipeline (``--steps``, ``--cfg-scale``,
``--no-cfg-batch``). The quality/speed dials ``--attn-broadcast-interval``,
``--teacache-threshold`` and (dev) ``--cfg-cache-interval`` pass to
``generate_video``; ``--enhance-prompt`` rewrites the prompt with the
text encoder's Gemma first (``--temperature``, ``--max-tokens``). Conditionings: ``--image PATH [FRAME_IDX] [STRENGTH]``
(or ``--condition-image`` with ``--image-frame-idx`` and
``--image-strength``), and for the distilled pipelines
``--video-conditioning`` (``--reference-video``: one at frame 0, strength
1); ``--pipeline keyframe`` puts images in guide mode and ``ic_lora`` needs a
video. As in the JAX CLI, ``--conditioning-mode`` is accepted and never read:
the pipeline decides the mode. ``--audio`` adds synchronized audio
(``--skip-audio`` turns it off again): ``--audio-mode`` joint (an AudioVideo
transformer; the dev pipeline's default) or separate (an AudioOnly
transformer after the video, ``--audio-steps``, from ``--audio-model-repo`` or
the snapshot; the other pipelines' default); the WAV goes to
``--output-audio`` (default: the mp4's name with ``.wav``) and is muxed into
the mp4 by ffmpeg (``--audio-filter``, ``--audio-bitrate``, default
``$LTX_AUDIO_BITRATE`` or 256k) when ffmpeg exists. The audio context comes
from the text encoder or from the embeddings file's ``audio`` and
``audio_neg`` entries.

Instrumentation, as in the JAX CLI: ``--profile`` prints the phase report
and, with ``--mem-log``, device memory lines at the ends of the denoise
stages; ``--trace-dir`` (or ``--metal-capture-path``; ``--metal-capture``
alone: ``./trace``) writes a ``torch.profiler`` trace of the generation;
``--debug`` and ``--verbose`` set ``MLX_VIDEO_DEBUG=1`` (utils/debug.py).
The JAX CLI's no-op flags are taken as it takes them: five print a note that
they have no effect, six (``--cfg-batch``, ``--compile``, ``--no-compile``,
``--compile-shapeless``, ``--fp32-euler``, ``--clear-cache``) are silent, and
``--metal-capture-phase`` is read by nothing.

Sharded generation (parallel/), under ``torchrun --nproc-per-node N -m
mlx_video_tpu_torch.generate``: ``--mesh d,f,t`` (or ``auto``) shards the
transformers (the AudioVideo and AudioOnly ones with ``--audio`` too) over
a (data, fsdp, tensor) mesh of the N ranks (``--sequence-parallel``: ring
self-attention over ``fsdp``), and the Gemma text encoder of a prompt run
by the same rules; ``--pipeline-parallel P`` runs GPipe over P stages
(``--pipeline-tensor T`` TP ways inside each; then N = P * T). Each rank
runs on ``cuda:LOCAL_RANK`` (or the CPU with ``--device cpu``, over gloo)
and decodes the video and the audio; only rank 0 prints the run's lines and
writes files (the mp4 and the WAV). A mesh or stages of more than one rank
without a launcher exit naming ``torchrun``; ``--mesh 1,1,1`` runs in one
process.

The options of :data:`_REFUSED` exit with a message that names them and
what they wait for; none is ignored.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import time
from pathlib import Path

import torch

from mlx_video_tpu_torch.parallel import TRAINER_ITEM


def _cond_arg(values):
    """PATH [FRAME_IDX] [STRENGTH] repeatable argument."""
    path = values[0]
    frame_idx = int(values[1]) if len(values) > 1 else 0
    strength = float(values[2]) if len(values) > 2 else 1.0
    return (path, frame_idx, strength)


def slugify(text: str, max_len: int = 80) -> str:
    """(reference: generate.py:372-379)."""
    text = re.sub(r"[^a-z0-9]+", "-", text.strip().lower()).strip("-")
    return (text or "video")[:max_len].strip("-")


def base_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flag surface (mlx_video_tpu/cli/generate.py:build_parser)."""
    p = argparse.ArgumentParser(description="LTX-2 video generation (TPU)")
    p.add_argument("--prompt", "-p", required=True)
    p.add_argument("--negative-prompt", default=None)
    p.add_argument("--height", "-H", type=int, default=512)
    p.add_argument("--width", "-W", type=int, default=512)
    p.add_argument("--num-frames", "-n", type=int, default=33)
    p.add_argument("--seed", "-s", type=int, default=42)
    p.add_argument("--num-videos", type=int, default=1,
                   help="Batch N videos through every denoise scan (new vs "
                        "the reference; video i uses seed+i, outputs "
                        "{stem}_{i}.mp4). T2V only - no audio/conditioning.")
    p.add_argument("--fps", "--frame-rate", type=float, default=24.0)
    p.add_argument("--output-path", "--output", "-o", default="output.mp4")
    p.add_argument("--auto-output-name", action="store_true")
    p.add_argument("--save-frames", action="store_true")
    p.add_argument("--model-repo", default="Lightricks/LTX-2")
    p.add_argument("--pipeline", default="distilled",
                   choices=["distilled", "dev", "keyframe", "ic_lora"])
    p.add_argument("--steps", "--num-inference-steps", type=int, default=40, dest="steps")
    p.add_argument("--stage1-steps", type=int, default=8)
    p.add_argument("--stage2-steps", type=int, default=3)
    p.add_argument("--sigma-subsample", default="farthest", choices=["uniform", "farthest"])
    p.add_argument("--cfg-scale", "--cfg-guidance-scale", "--guidance-scale",
                   type=float, default=4.0, dest="cfg_scale")
    p.add_argument("--stage2-dev", action="store_true")
    p.add_argument("--stage2-model-repo", default=None)
    p.add_argument("--image", action="append", nargs="+", default=[])
    p.add_argument("--condition-image", default=None,
                   help="Single conditioning image (combine with --image-frame-idx/"
                        "--image-strength); equivalent to one --image entry")
    p.add_argument("--image-frame-idx", type=int, default=0)
    p.add_argument("--image-strength", type=float, default=1.0)
    p.add_argument("--video-conditioning", action="append", nargs="+", default=[])
    p.add_argument("--reference-video", default=None,
                   help="Alias for --video-conditioning PATH 0 1.0 (IC-LoRA)")
    p.add_argument("--conditioning-mode", default="replace", choices=["replace", "guide"])
    p.add_argument("--lora", "--lora-path", action="append", default=[], dest="lora")
    p.add_argument("--lora-strength", type=float, default=1.0)
    p.add_argument("--distilled-lora", action="append", default=[])
    p.add_argument("--audio", action="store_true")
    p.add_argument("--skip-audio", action="store_true",
                   help="Force audio off even for AV checkpoints")
    p.add_argument("--audio-mode", default="auto", choices=["auto", "joint", "separate"])
    p.add_argument("--audio-steps", type=int, default=8,
                   help="Denoise steps for separate audio generation")
    p.add_argument("--audio-filter", default=None,
                   help="ffmpeg -af filter chain applied when muxing audio")
    p.add_argument("--audio-bitrate", default=None,
                   help="AAC bitrate for the audio mux (default 256k or "
                        "$LTX_AUDIO_BITRATE; reference: generate.py:4446)")
    p.add_argument("--include-reference-in-output", action="store_true",
                   help="(PyTorch parity) Not implemented; ignored "
                        "(matches the reference, generate.py:4368, 4672)")
    p.add_argument("--audio-model-repo", default=None,
                   help="Separate repo for the AudioOnly transformer")
    p.add_argument("--output-audio", default=None)
    p.add_argument("--enhance-prompt", action="store_true")
    p.add_argument("--temperature", type=float, default=0.7,
                   help="Prompt-enhancement sampling temperature")
    p.add_argument("--max-tokens", type=int, default=512,
                   help="Prompt-enhancement max new tokens")
    p.add_argument("--stream", action="store_true")
    p.add_argument("--tiling", default="auto",
                   choices=["auto", "none", "default", "aggressive", "conservative",
                            "spatial", "temporal"])
    p.add_argument("--video-encoder", default="ffmpeg", choices=["ffmpeg", "cv2"])
    p.add_argument("--checkpoint-path", "--checkpoint", default=None, dest="checkpoint_path")
    p.add_argument("--gemma-root", "--text-encoder-path", "--text-encoder-repo",
                   default=None, dest="text_encoder_path")
    p.add_argument("--embeddings", default=None,
                   help="Precomputed text embeddings safetensors "
                        "(video[_neg]/audio[_neg] keys); skips the text encoder")
    p.add_argument("--latents-only", action="store_true")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--profile-json", "--profile-json-path", default=None,
                   dest="profile_json_path")
    p.add_argument("--mem-log", action="store_true",
                   help="Log device memory at pipeline checkpoints")
    p.add_argument("--debug", action="store_true",
                   help="Tensor-stat dumps at pipeline seams (sets MLX_VIDEO_DEBUG)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--trace-dir", "--metal-capture-path", default=None, dest="trace_dir",
                   help="jax.profiler trace output dir (the TPU equivalent of the "
                        "reference's Metal GPU capture)")
    p.add_argument("--metal-capture", action="store_true",
                   help="(TPU) use --trace-dir; enables a jax.profiler trace to ./trace")
    p.add_argument("--metal-capture-phase", default=None, help=argparse.SUPPRESS)
    p.add_argument("--quantization", "--quantize-bits", type=int, default=None,
                   choices=[4, 8], dest="quantize_bits",
                   help="Runtime-quantize the transformer")
    p.add_argument("--w8a8", action="store_true",
                   help="Run transformer-block matmuls as W8A8 int8 (2x MXU "
                        "rate + half the weight HBM traffic; per-token dynamic "
                        "activation scales, ops/int8.py)")
    p.add_argument("--w4a8", action="store_true",
                   help="q4 weight storage + int8 MXU compute: quantize the "
                        "transformer to 4-bit (or use a pre-quantized repo) "
                        "and requantize each layer to int8 inside the graph "
                        "(ops/quant.py prepare_w4a8). Fits 19B on one 16 GB "
                        "chip at the 2x int8 matmul rate.")
    p.add_argument("--mesh", default=None,
                   help="data,fsdp,tensor mesh shape for sharded (GSPMD) inference, "
                        "e.g. 1,1,8 for 8-way tensor parallelism; 'auto' uses all "
                        "local devices. The denoise scan compiles as one SPMD "
                        "program with XLA collectives over the mesh.")
    p.add_argument("--sequence-parallel", action="store_true",
                   help="With --mesh: also shard the token axis over the fsdp "
                        "mesh axis and run self-attention as ring attention "
                        "(long-video sequence parallelism)")
    p.add_argument("--pipeline-parallel", type=int, default=0,
                   help="GPipe pipeline parallelism: split the DiT block "
                        "stack into N stages on a (data, pipe) mesh "
                        "(parallel/pipeline.py). Mutually exclusive with "
                        "--mesh/--sequence-parallel; targets cross-slice "
                        "(DCN) scale-out and batch serving.")
    p.add_argument("--pipeline-tensor", type=int, default=1,
                   help="Megatron TP ways inside each pipeline stage "
                        "(GSPMD auto axis; TPxPP composition).")
    p.add_argument("--attn-broadcast-interval", type=int, default=1,
                   help="Pyramid Attention Broadcast: recompute all per-layer "
                        "attention outputs every k-th denoise step and reuse "
                        "them in between (cached steps skip all attention "
                        "compute). Video-only quality/speed dial.")
    p.add_argument("--cfg-cache-interval", type=int, default=1,
                   help="Dev CFG: recompute the guidance delta every k-th "
                        "step and reuse it in between (cached steps run one "
                        "batch-1 forward instead of the batched 2B one) - "
                        "~25%% fewer denoise FLOPs at k=2 for a small "
                        "guidance drift. Video-only CFG.")
    p.add_argument("--teacache-threshold", type=float, default=0.0,
                   help="TeaCache adaptive caching: accumulate the relative "
                        "change of the transformer's timestep-modulated input "
                        "across steps and only run the full forward when it "
                        "crosses this threshold (cached steps reuse the "
                        "previous velocity and skip the forward entirely). "
                        "0 disables; try 0.05-0.3 (higher = faster, lossier). "
                        "Video-only; exclusive with the fixed-interval dials.")
    p.add_argument("--low-memory", action="store_true",
                   help="Single-chip HBM staging: keep the VAE decoder/"
                        "upsampler/audio weights on the host during denoise "
                        "and free the transformer before decode (the "
                        "reference's serial load/free choreography as "
                        "host<->HBM swaps). Needed to fit 19B W4A8 + the "
                        "full 1024-channel decoder on one 16 GB chip.")
    p.add_argument("--aux-stage-int8", action="store_true",
                   help="With --low-memory: park the aux-stage params "
                        "(upsampler/VAE/audio) host-side as per-group "
                        "int8 so each staging transfer moves half the "
                        "bytes; dequantized to bf16 on device.")
    p.add_argument("--aux-park-device", action="store_true",
                   help="With --aux-stage-int8: park the int8 aux trees in "
                        "HBM instead of host RAM — no staging transfers at "
                        "all when the ~2x-smaller parked form fits beside "
                        "the transformer and its scan arena.")
    p.add_argument("--no-overlap-staging", action="store_true",
                   help="With --low-memory: disable the async aux-param "
                        "prefetch that overlaps the host->HBM staging "
                        "transfers with the denoise scans (use when the "
                        "geometry's scan arena leaves no HBM headroom for "
                        "the in-flight buffers).")
    p.add_argument("--optimize-layouts", action="store_true",
                   help="Pre-place the transformer weights in XLA's "
                        "preferred input layouts for this geometry before "
                        "the denoise scan compiles (one extra cached "
                        "discovery compile). Removes multi-GB in-program "
                        "relayout copies of the stacked weight tensors — "
                        "required to fit the 19B batched-CFG dev pipeline "
                        "on one 16 GB chip. Single-device runs only.")
    p.add_argument("--no-cfg-batch", action="store_true",
                   help="Dev CFG: run the conditional and unconditional "
                        "forwards sequentially (two batch-B passes per step) "
                        "instead of one batched 2B pass. Halves denoise-time "
                        "activation memory at the same FLOPs; use when the "
                        "batched 2B forward does not fit. (Reference "
                        "--no-cfg-batch: mlx_video/generate.py cfg_batch.)")
    # Reference-CLI flags that are no-ops under the TPU execution model:
    # the whole sigma loop is one compiled lax.scan (always "compiled",
    # always fp32 Euler, no lazy-eval cache to tune). CFG is batched by
    # default (--cfg-batch) and --no-cfg-batch above switches to the real
    # sequential path.
    for flag, action in [
        ("--cfg-batch", "store_true"),
        ("--compile", "store_true"), ("--no-compile", "store_true"),
        ("--compile-shapeless", "store_true"), ("--fp32-euler", "store_true"),
        ("--clear-cache", "store_true"),
    ]:
        p.add_argument(flag, action=action, help=argparse.SUPPRESS)
    p.add_argument("--eval-interval", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--cache-limit-gb", type=float, default=None, help=argparse.SUPPRESS)
    p.add_argument("--memory-limit-gb", type=float, default=None, help=argparse.SUPPRESS)
    # PT-parity no-ops (reference: generate.py:4521-4524)
    p.add_argument("--stg-scale", type=float, default=None, help=argparse.SUPPRESS)
    p.add_argument("--stg-blocks", type=int, nargs="*", default=None, help=argparse.SUPPRESS)
    p.add_argument("--stg-mode", default=None, help=argparse.SUPPRESS)
    p.add_argument("--enable-fp8", action="store_true", help=argparse.SUPPRESS)
    return p


# The JAX parser's options that the port refuses, with what they wait for;
# each exits when it is given a value other than its default.
_LEFT_OUT = "a 16 GB accelerator's memory plan or XLA's layouts, left out of the port (ROADMAP 'Leave out')"
_REFUSED = {
    "low_memory": _LEFT_OUT, "aux_stage_int8": _LEFT_OUT, "aux_park_device": _LEFT_OUT,
    "no_overlap_staging": _LEFT_OUT, "optimize_layouts": _LEFT_OUT,
}
# What the trainer's parallel options wait for (their refusals name this
# ROADMAP item).
PARALLEL_TRAIN = f"the GPipe stages of the trainer ({TRAINER_ITEM})"


def build_parser() -> argparse.ArgumentParser:
    p = base_parser()
    p.description = ("LTX-2 video generation, distilled, keyframe, IC-LoRA and dev pipelines, with or without "
                     "audio (PyTorch, CUDA)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; exits when CUDA is absent)")
    return p


def unported_flags(args: argparse.Namespace, parser: argparse.ArgumentParser) -> list:
    """Messages for the options in ``args`` that ask for what the port does
    not have."""
    return [f"{action.option_strings[0]} ({_REFUSED[action.dest]})" for action in parser._actions
            if action.dest in _REFUSED and getattr(args, action.dest, action.default) != action.default]


def note_ignored_flags(args: argparse.Namespace) -> None:
    """The JAX CLI's note for each flag it takes and ignores."""
    for flag, val in [
        ("--enable-fp8", args.enable_fp8),
        ("--stg-scale/--stg-blocks/--stg-mode",
         args.stg_scale is not None or args.stg_blocks is not None or args.stg_mode),
        ("--eval-interval", args.eval_interval is not None),
        ("--cache-limit-gb/--memory-limit-gb", args.cache_limit_gb is not None or args.memory_limit_gb is not None),
        ("--include-reference-in-output", args.include_reference_in_output),
    ]:
        if val:
            print(f"note: {flag} has no effect on the GPU (ignored)")


def load_embeddings(path, device=None):
    """Precomputed text embeddings (``video`` or ``video_prompt_embeds``, and
    the negative prompt's ``video_neg`` if present; the audio context's
    ``audio`` or ``audio_prompt_embeds`` and ``audio_neg`` likewise; a 2-D
    array gains a batch axis) -> TextConditioning on ``device``."""
    from mlx_video_tpu_torch.io.safetensors import SafetensorsReader
    from mlx_video_tpu_torch.pipelines.generate import TextConditioning

    with SafetensorsReader(path) as r:
        def get(name):
            if name not in r:
                return None
            emb = r.get(name, device)
            return emb[None] if emb.dim() == 2 else emb

        video = get("video") if "video" in r else get("video_prompt_embeds")
        if video is None:
            raise ValueError(f"{path} holds no 'video' or 'video_prompt_embeds' embeddings")
        return TextConditioning(
            video_embeddings=video, video_neg_embeddings=get("video_neg"),
            audio_embeddings=get("audio") if "audio" in r else get("audio_prompt_embeds"),
            audio_neg_embeddings=get("audio_neg"),
        )


def _synced(device: torch.device) -> float:
    """The host clock after a device synchronise on CUDA."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def encode_prompts(args, model_path: Path, device: torch.device, dtype, phases: dict, mesh=None):
    """The prompt (and, for the dev pipeline and ``--stage2-dev``, the
    negative prompt: the given one or the default) through the Gemma-3 text encoder of
    ``--text-encoder-path`` (else the snapshot), bf16 or with ``--w8a8``
    W8A8, in ``dtype`` on ``device``, sharded over ``mesh`` when given (as
    the JAX CLI holds it beside the sharded DiT); the encoder is freed after. Adds the
    ``text_encoder_load`` and ``text_encode`` phase seconds (the latter
    includes ``--enhance-prompt``'s generation: the I2V system prompt with
    ``--image``, else the T2V one, at ``--temperature`` for ``--max-tokens``).
    The audio contexts come from the same encodes."""
    from mlx_video_tpu_torch.models.ltx.text_encoder import LTX2TextEncoder
    from mlx_video_tpu_torch.pipelines.generate import TextConditioning
    from mlx_video_tpu_torch.pipelines.prompts import DEFAULT_NEGATIVE_PROMPT

    t0 = _synced(device)
    encoder = LTX2TextEncoder.load(model_path, args.text_encoder_path or model_path, dtype=dtype, w8a8=args.w8a8,
                                   device=device)
    if mesh is not None:
        encoder.shard(mesh)
    t1 = _synced(device)
    prompt = args.prompt
    if args.enhance_prompt:
        enhance_kwargs = dict(temperature=args.temperature, max_new_tokens=args.max_tokens)
        prompt = (encoder.enhance_i2v(prompt, **enhance_kwargs) if args.image
                  else encoder.enhance_t2v(prompt, **enhance_kwargs))
        print(f"Enhanced prompt: {prompt}", flush=True)
    video, audio = encoder.encode(prompt)
    neg = args.negative_prompt
    if neg is None and (args.pipeline == "dev" or args.stage2_dev):
        neg = DEFAULT_NEGATIVE_PROMPT
    video_neg, audio_neg = encoder.encode(neg) if neg else (None, None)
    phases["text_encoder_load"], phases["text_encode"] = t1 - t0, _synced(device) - t1
    del encoder
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return TextConditioning(video_embeddings=video, video_neg_embeddings=video_neg, audio_embeddings=audio,
                            audio_neg_embeddings=audio_neg)


def save_frames(video, output_path: Path) -> None:
    """PNG frames of each (3, F, H, W) video in ``video``, to
    ``{output_path without suffix}[_{i}]/frame_{n:05d}.png`` (``_{i}`` when
    there are several videos), as the JAX CLI."""
    from PIL import Image

    from mlx_video_tpu_torch.io.media import frames_to_uint8

    for vid in range(video.shape[0]):
        frames_dir = output_path.with_suffix("")
        if video.shape[0] > 1:
            frames_dir = frames_dir.with_name(f"{frames_dir.name}_{vid}")
        frames_dir.mkdir(parents=True, exist_ok=True)
        for i, frame in enumerate(frames_to_uint8(video[vid : vid + 1])):
            Image.fromarray(frame).save(frames_dir / f"frame_{i:05d}.png")


def _parallel_start(args, device: torch.device, prog: str = "generate") -> torch.device:
    """Check the parallel flags and join the launcher's process group;
    returns this rank's device (``cuda:LOCAL_RANK`` under a launcher).
    ``prog`` names the command in the messages."""
    from mlx_video_tpu_torch.parallel import distributed

    if not (args.mesh or args.pipeline_parallel):
        return device
    ranks = args.pipeline_parallel * args.pipeline_tensor if args.pipeline_parallel else (
        1 if args.mesh == "auto" else math.prod(int(x) for x in args.mesh.split(",")))
    if ranks > 1 and not distributed.launched():
        given = (f"--mesh {args.mesh}" + (" --sequence-parallel" if args.sequence_parallel else "")
                 if args.mesh else f"--pipeline-parallel {args.pipeline_parallel} --pipeline-tensor "
                 f"{args.pipeline_tensor}")
        raise SystemExit(f"{prog}: {given} needs {ranks} processes: launch it with torchrun --nproc-per-node "
                         f"{ranks} -m mlx_video_tpu_torch.{prog} ...")
    distributed.initialize_multihost(device_type=device.type)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", distributed.local_rank())
    return device


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    unported = unported_flags(args, parser)
    if unported:
        raise SystemExit("generate: not ported to mlx_video_tpu_torch yet: " + "; ".join(unported))
    if args.mesh and args.pipeline_parallel:
        # fail before minutes of weight loading, not inside generate_video
        raise SystemExit("generate: --mesh and --pipeline-parallel are mutually exclusive")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("generate: --device cuda but CUDA is not available (pass --device cpu to run on the CPU)")
    device = _parallel_start(args, device)
    try:
        _run(args, device)
    finally:
        if args.trace_dir:  # torch.profiler can leave the run's frame, models and all, in a reference cycle
            gc.collect()
        if args.mesh or args.pipeline_parallel:
            from mlx_video_tpu_torch.parallel.distributed import shutdown

            shutdown()


def _run(args, device: torch.device) -> None:
    from mlx_video_tpu_torch.parallel.distributed import is_primary_host

    primary = is_primary_host()
    if args.debug or args.verbose:
        os.environ["MLX_VIDEO_DEBUG"] = "1"
    if args.skip_audio:
        args.audio = False
    if args.metal_capture and not args.trace_dir:
        args.trace_dir = "trace"
    note_ignored_flags(args)
    if args.condition_image:
        args.image.append([args.condition_image, str(args.image_frame_idx), str(args.image_strength)])
    if args.reference_video:
        args.video_conditioning.append([args.reference_video, "0", "1.0"])

    from mlx_video_tpu_torch import loading
    from mlx_video_tpu_torch.lora import LoraSpec, merge_lora_into_params
    from mlx_video_tpu_torch.pipelines.generate import generate_video
    from mlx_video_tpu_torch.utils.hub import get_model_path
    from mlx_video_tpu_torch.utils.profiling import device_trace

    model_path = get_model_path(args.checkpoint_path or args.model_repo)
    t0 = time.perf_counter()
    models = loading.load_model_bundle(
        model_path, pipeline=args.pipeline, bits_hint=loading.bits_hint_for(args.checkpoint_path or args.model_repo),
        stage2_path=get_model_path(args.stage2_model_repo) if args.stage2_model_repo else None,
        load_encoder=bool(args.image or args.video_conditioning), device=device,
        audio=args.audio, audio_mode=args.audio_mode,
        audio_model_path=get_model_path(args.audio_model_repo) if args.audio_model_repo else None,
    )
    merge_s = None
    if args.lora or args.distilled_lora:
        # merged into the dense weights before quantization, as the JAX CLI
        t1 = _synced(device)
        if args.lora:
            specs = [LoraSpec(Path(p), args.lora_strength) for p in args.lora]
            models.transformer = merge_lora_into_params(models.transformer, specs, verbose=True)
        if args.distilled_lora:
            specs = [LoraSpec(Path(p), args.lora_strength) for p in args.distilled_lora]
            base = models.stage2_transformer if models.stage2_transformer is not None else models.transformer
            models.stage2_transformer = merge_lora_into_params(base, specs, verbose=True)
        merge_s = _synced(device) - t1
    try:
        loading.quantize_models(models, model_path, w8a8=args.w8a8, w4a8=args.w4a8,
                                quantize_bits=args.quantize_bits,
                                repo_hint=str(args.checkpoint_path or args.model_repo))
    except ValueError as e:
        raise SystemExit(str(e))
    mesh = None
    if args.mesh:
        mesh = loading.mesh_from_flag(args.mesh, device.type)
        loading.shard_models(models, mesh)
        if primary:
            print(f"Sharded transformer over mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}", flush=True)
    phases = {"load": _synced(device) - t0 - (merge_s or 0.0)}
    if merge_s is not None:
        phases["lora_merge"] = merge_s
    if primary:
        print(f"Loaded {model_path} in {phases['load']:.2f} s", flush=True)
    if args.embeddings:
        text = load_embeddings(args.embeddings, device)
    else:
        text = encode_prompts(args, model_path, device, models.transformer.video.scale_shift_table.dtype, phases,
                              mesh=mesh)

    output_path = Path(args.output_path)
    if args.auto_output_name:
        output_path = output_path.parent / f"{slugify(args.prompt)}.mp4"
    with device_trace(args.trace_dir, device):
        result = generate_video(
            models,
            text,
            height=args.height,
            width=args.width,
            num_frames=args.num_frames,
            fps=args.fps,
            seed=args.seed,
            num_videos=args.num_videos,
            stage1_steps=args.stage1_steps,
            stage2_steps=args.stage2_steps,
            sigma_subsample=args.sigma_subsample,
            stage2_cfg=args.stage2_dev,
            pipeline=args.pipeline,
            cfg_scale=args.cfg_scale,
            num_inference_steps=args.steps,
            cfg_sequential=args.no_cfg_batch,
            cfg_cache_interval=args.cfg_cache_interval,
            attn_broadcast_interval=args.attn_broadcast_interval,
            teacache_threshold=args.teacache_threshold,
            images=[_cond_arg(v) for v in args.image],
            video_conditionings=[_cond_arg(v) for v in args.video_conditioning],
            output_path=None if args.latents_only else output_path,
            tiling=args.tiling,
            stream=args.stream,
            decode_latents_only=args.latents_only,
            video_encoder=args.video_encoder,
            dtype=models.transformer.video.scale_shift_table.dtype,  # the dtype it was loaded in
            audio=args.audio,
            audio_mode=args.audio_mode,
            audio_steps=args.audio_steps,
            audio_filter=args.audio_filter,
            audio_bitrate=args.audio_bitrate or os.getenv("LTX_AUDIO_BITRATE", "256k"),
            output_audio_path=args.output_audio,
            profile=args.profile,
            mem_log=args.mem_log,
            mesh=mesh,
            sequence_parallel=args.sequence_parallel,
            pipeline_parallel=args.pipeline_parallel,
            pipeline_tensor=args.pipeline_tensor,
        )

    if not primary:
        return
    if args.save_frames and result.video is not None:
        save_frames(result.video, output_path)
    phases.update(result.phase_seconds)
    if args.verbose:
        for name, secs in phases.items():
            print(f"  {name:<24} {secs:8.2f}s")
    if args.profile_json_path:
        path = Path(args.profile_json_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"phases": phases, "total": sum(phases.values())}, indent=2))
    if result.video_path is not None:
        print(f"Saved video to {result.video_path}")
    if result.audio_path is not None:
        print(f"Saved audio to {result.audio_path}")


if __name__ == "__main__":
    main()
