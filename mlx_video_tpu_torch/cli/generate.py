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
``--no-cfg-batch``). Conditionings: ``--image PATH [FRAME_IDX] [STRENGTH]``
(or ``--condition-image`` with ``--image-frame-idx`` and
``--image-strength``), and for the distilled pipelines
``--video-conditioning`` (``--reference-video``: one at frame 0, strength
1); ``--pipeline keyframe`` puts images in guide mode and ``ic_lora`` needs a
video. As in the JAX CLI, ``--conditioning-mode`` is accepted and never read:
the pipeline decides the mode.

Flags of features the port does not have yet exit with a message that names
them; none is ignored.
"""

from __future__ import annotations

import argparse
import json
import re
import time
from pathlib import Path

import torch

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


# The options main() reads. Any other option of the JAX parser asks for a
# feature the port does not have yet, and exits when it is given a value other
# than its default.
_PORTED = frozenset({
    "prompt", "height", "width", "num_frames", "seed", "fps", "output_path", "auto_output_name",
    "model_repo", "checkpoint_path", "embeddings", "stage1_steps", "stage2_steps", "tiling",
    "video_encoder", "latents_only", "profile_json_path", "verbose", "quantize_bits", "pipeline",
    "device", "steps", "cfg_scale", "no_cfg_batch", "image", "condition_image", "image_frame_idx",
    "image_strength", "w8a8", "w4a8", "text_encoder_path", "negative_prompt", "lora", "lora_strength",
    "distilled_lora", "stage2_model_repo", "stage2_dev", "video_conditioning", "reference_video",
    "conditioning_mode", "stream", "sigma_subsample", "num_videos", "save_frames",
})


def build_parser() -> argparse.ArgumentParser:
    p = base_parser()
    p.description = "LTX-2 video generation, distilled, keyframe, IC-LoRA and dev pipelines (PyTorch, CUDA)"
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; exits when CUDA is absent)")
    return p


def unported_flags(args: argparse.Namespace, parser: argparse.ArgumentParser) -> list:
    """Messages for the options in ``args`` that ask for what the port does
    not have yet."""
    return [action.option_strings[0] for action in parser._actions
            if action.dest not in _PORTED and action.option_strings
            and getattr(args, action.dest, action.default) != action.default]


def load_embeddings(path, device=None):
    """Precomputed text embeddings (``video`` or ``video_prompt_embeds``, and
    the negative prompt's ``video_neg`` if present; a 2-D array gains a batch
    axis) -> TextConditioning on ``device``."""
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
        return TextConditioning(video_embeddings=video, video_neg_embeddings=get("video_neg"))


def _synced(device: torch.device) -> float:
    """The host clock after a device synchronise on CUDA."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def encode_prompts(args, model_path: Path, device: torch.device, dtype, phases: dict):
    """The prompt (and, for the dev pipeline and ``--stage2-dev``, the
    negative prompt: the given one or the default) through the Gemma-3 text encoder of
    ``--text-encoder-path`` (else the snapshot), bf16 or with ``--w8a8``
    W8A8, in ``dtype`` on ``device``; the encoder is freed after. Adds the
    ``text_encoder_load`` and ``text_encode`` phase seconds."""
    from mlx_video_tpu_torch.models.ltx.text_encoder import LTX2TextEncoder
    from mlx_video_tpu_torch.pipelines.generate import TextConditioning
    from mlx_video_tpu_torch.pipelines.prompts import DEFAULT_NEGATIVE_PROMPT

    t0 = _synced(device)
    encoder = LTX2TextEncoder.load(model_path, args.text_encoder_path or model_path, dtype=dtype, w8a8=args.w8a8,
                                   device=device)
    t1 = _synced(device)
    video, _ = encoder.encode(args.prompt)
    neg = args.negative_prompt
    if neg is None and (args.pipeline == "dev" or args.stage2_dev):
        neg = DEFAULT_NEGATIVE_PROMPT
    video_neg = encoder.encode(neg)[0] if neg else None
    phases["text_encoder_load"], phases["text_encode"] = t1 - t0, _synced(device) - t1
    del encoder
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return TextConditioning(video_embeddings=video, video_neg_embeddings=video_neg)


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


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    unported = unported_flags(args, parser)
    if unported:
        raise SystemExit("generate: not ported to mlx_video_tpu_torch yet: " + "; ".join(unported))
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("generate: --device cuda but CUDA is not available (pass --device cpu to run on the CPU)")
    if args.condition_image:
        args.image.append([args.condition_image, str(args.image_frame_idx), str(args.image_strength)])
    if args.reference_video:
        args.video_conditioning.append([args.reference_video, "0", "1.0"])

    from mlx_video_tpu_torch import loading
    from mlx_video_tpu_torch.lora import LoraSpec, merge_lora_into_params
    from mlx_video_tpu_torch.pipelines.generate import generate_video
    from mlx_video_tpu_torch.utils.hub import get_model_path

    model_path = get_model_path(args.checkpoint_path or args.model_repo)
    t0 = time.perf_counter()
    models = loading.load_model_bundle(
        model_path, pipeline=args.pipeline, bits_hint=loading.bits_hint_for(args.checkpoint_path or args.model_repo),
        stage2_path=get_model_path(args.stage2_model_repo) if args.stage2_model_repo else None,
        load_encoder=bool(args.image or args.video_conditioning), device=device,
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
    phases = {"load": _synced(device) - t0 - (merge_s or 0.0)}
    if merge_s is not None:
        phases["lora_merge"] = merge_s
    print(f"Loaded {model_path} in {phases['load']:.2f} s", flush=True)
    if args.embeddings:
        text = load_embeddings(args.embeddings, device)
    else:
        text = encode_prompts(args, model_path, device, models.transformer.video.scale_shift_table.dtype, phases)

    output_path = Path(args.output_path)
    if args.auto_output_name:
        output_path = output_path.parent / f"{slugify(args.prompt)}.mp4"
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
        images=[_cond_arg(v) for v in args.image],
        video_conditionings=[_cond_arg(v) for v in args.video_conditioning],
        output_path=None if args.latents_only else output_path,
        tiling=args.tiling,
        stream=args.stream,
        decode_latents_only=args.latents_only,
        video_encoder=args.video_encoder,
        dtype=models.transformer.video.scale_shift_table.dtype,  # the dtype it was loaded in
    )

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


if __name__ == "__main__":
    main()
