"""``python -m mlx_video_tpu_torch.generate`` — the distilled text-to-video CLI.

Counterpart of mlx_video_tpu/cli/generate.py on the same flag names (the JAX
package's framework-free ``build_parser``), plus ``--device`` (default
``cuda``; without CUDA it exits rather than run on the CPU, which takes
``--device cpu``). The run starts from precomputed text embeddings
(``--embeddings``): load the snapshot, optionally quantize the transformer
(``--quantization``), generate, write the mp4 and, with
``--profile-json-path``, the phase seconds.

Flags of features the port does not have yet exit with a message that names
them; none is ignored.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from mlx_video_tpu.cli.generate import build_parser as _jax_parser
from mlx_video_tpu.cli.generate import slugify

# The options main() reads. Any other option of the JAX parser asks for a
# feature the port does not have yet, and exits when it is given a value other
# than its default.
_PORTED = frozenset({
    "prompt", "height", "width", "num_frames", "seed", "fps", "output_path", "auto_output_name",
    "model_repo", "checkpoint_path", "embeddings", "stage1_steps", "stage2_steps", "tiling",
    "video_encoder", "latents_only", "profile_json_path", "verbose", "quantize_bits", "pipeline",
    "device",
})


def build_parser() -> argparse.ArgumentParser:
    p = _jax_parser()
    p.description = "LTX-2 distilled text-to-video generation (PyTorch, CUDA)"
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; exits when CUDA is absent)")
    return p


def unported_flags(args: argparse.Namespace, parser: argparse.ArgumentParser) -> list:
    """Messages for the options in ``args`` that ask for what the port does
    not have yet."""
    msgs = [action.option_strings[0] for action in parser._actions
            if action.dest not in _PORTED and action.option_strings
            and getattr(args, action.dest, action.default) != action.default]
    if args.pipeline != "distilled":
        msgs.append(f"--pipeline {args.pipeline} (only the distilled pipeline is ported)")
    if not args.embeddings:
        msgs.append("a prompt without --embeddings (the Gemma text encoder)")
    return msgs


def load_embeddings(path, device=None):
    """Precomputed text embeddings (``video`` or ``video_prompt_embeds``;
    a 2-D array gains a batch axis) -> TextConditioning on ``device``."""
    from mlx_video_tpu_torch.io.safetensors import SafetensorsReader
    from mlx_video_tpu_torch.pipelines.generate import TextConditioning

    with SafetensorsReader(path) as r:
        name = "video" if "video" in r else "video_prompt_embeds"
        if name not in r:
            raise ValueError(f"{path} holds no 'video' or 'video_prompt_embeds' embeddings")
        emb = r.get(name, device)
    return TextConditioning(video_embeddings=emb[None] if emb.dim() == 2 else emb)


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    unported = unported_flags(args, parser)
    if unported:
        raise SystemExit("generate: not ported to mlx_video_tpu_torch yet: " + "; ".join(unported))
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("generate: --device cuda but CUDA is not available (pass --device cpu to run on the CPU)")

    from mlx_video_tpu.utils.hub import get_model_path
    from mlx_video_tpu_torch import loading
    from mlx_video_tpu_torch.pipelines.generate import generate_video

    model_path = get_model_path(args.checkpoint_path or args.model_repo)
    t0 = time.perf_counter()
    models = loading.load_model_bundle(
        model_path, bits_hint=loading.bits_hint_for(args.checkpoint_path or args.model_repo), device=device,
    )
    try:
        loading.quantize_models(models, quantize_bits=args.quantize_bits)
    except ValueError as e:
        raise SystemExit(str(e))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    load_seconds = time.perf_counter() - t0
    print(f"Loaded {model_path} in {load_seconds:.2f} s", flush=True)
    text = load_embeddings(args.embeddings, device)

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
        stage1_steps=args.stage1_steps,
        stage2_steps=args.stage2_steps,
        output_path=None if args.latents_only else output_path,
        tiling=args.tiling,
        decode_latents_only=args.latents_only,
        video_encoder=args.video_encoder,
        dtype=models.transformer.video.scale_shift_table.dtype,  # the dtype it was loaded in
    )

    phases = {"load": load_seconds, **result.phase_seconds}
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
