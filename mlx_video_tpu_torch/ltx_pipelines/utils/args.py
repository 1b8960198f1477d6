"""Reusable argparse fragments for the pipeline CLIs
(reference: ltx_pipelines/utils/args.py:1-277).

Two surfaces live here:

- The PT-parity surface — ``resolve_path``, the three custom actions
  (``ImageAction``/``VideoConditioningAction``/``LoraAction``) and the four
  parser factories (``basic_arg_parser`` / ``default_1_stage_arg_parser`` /
  ``default_2_stage_arg_parser`` / ``default_2_stage_distilled_arg_parser``)
  — flag-for-flag with the reference (same dests, nargs, required-ness and
  defaults; pinned by tests/test_parity_packages.py).
- Additive CLI helpers (``add_common_args`` etc.) used by this repo's
  own pipeline mains, which keep looser UX (optional positional fields,
  repo-based weight resolution).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mlx_video_tpu_torch.ltx_core.loader import LTXV_LORA_COMFY_RENAMING_MAP, LoraPathStrengthAndSDOps
from mlx_video_tpu_torch.ltx_pipelines.utils.constants import (
    DEFAULT_1_STAGE_HEIGHT,
    DEFAULT_1_STAGE_WIDTH,
    DEFAULT_2_STAGE_HEIGHT,
    DEFAULT_2_STAGE_WIDTH,
    DEFAULT_CFG_GUIDANCE_SCALE,
    DEFAULT_FRAME_RATE,
    DEFAULT_LORA_STRENGTH,
    DEFAULT_NEGATIVE_PROMPT,
    DEFAULT_NUM_FRAMES,
    DEFAULT_NUM_INFERENCE_STEPS,
    DEFAULT_SEED,
)


def resolve_path(path: str) -> str:
    """Absolute posix path with ~ expansion (reference: args.py:77-78)."""
    return str(Path(path).expanduser().resolve().as_posix())


class VideoConditioningAction(argparse.Action):
    """--video-conditioning PATH STRENGTH, repeatable; accumulates
    (resolved_path, strength) tuples (reference: args.py:20-33)."""

    def __call__(self, parser, namespace, values, option_string=None):
        path, strength_str = values
        current = getattr(namespace, self.dest) or []
        current.append((resolve_path(path), float(strength_str)))
        setattr(namespace, self.dest, current)


class ImageAction(argparse.Action):
    """--image PATH FRAME_IDX STRENGTH, repeatable; accumulates
    (resolved_path, frame_idx, strength) tuples (reference: args.py:36-50)."""

    def __call__(self, parser, namespace, values, option_string=None):
        path, frame_idx, strength_str = values
        current = getattr(namespace, self.dest) or []
        current.append((resolve_path(path), int(frame_idx), float(strength_str)))
        setattr(namespace, self.dest, current)


class LoraAction(argparse.Action):
    """--lora PATH [STRENGTH], repeatable; accumulates
    LoraPathStrengthAndSDOps records (reference: args.py:53-74)."""

    def __call__(self, parser, namespace, values, option_string=None):
        if len(values) > 2:
            msg = (
                f"{option_string} accepts at most 2 arguments (PATH and "
                f"optional STRENGTH), got {len(values)} values"
            )
            raise argparse.ArgumentError(self, msg)
        path = values[0]
        strength_str = values[1] if len(values) > 1 else str(DEFAULT_LORA_STRENGTH)
        current = getattr(namespace, self.dest) or []
        current.append(
            LoraPathStrengthAndSDOps(
                resolve_path(path), float(strength_str), LTXV_LORA_COMFY_RENAMING_MAP
            )
        )
        setattr(namespace, self.dest, current)


def basic_arg_parser() -> argparse.ArgumentParser:
    """The shared flag set of every reference pipeline CLI
    (reference: args.py:81-185)."""
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--checkpoint-path", type=resolve_path, required=True,
        help="Path to LTX-2 model checkpoint (.safetensors file).",
    )
    parser.add_argument(
        "--gemma-root", type=resolve_path, required=True,
        help="Path to the root directory containing the Gemma text encoder model files.",
    )
    parser.add_argument(
        "--prompt", type=str, required=True,
        help="Text prompt describing the desired video content to be generated by the model.",
    )
    parser.add_argument(
        "--output-path", type=resolve_path, required=True,
        help="Path to the output video file (MP4 format).",
    )
    parser.add_argument(
        "--seed", type=int, default=DEFAULT_SEED,
        help=f"Random seed value used to initialize the noise tensor for "
             f"reproducible generation (default: {DEFAULT_SEED}).",
    )
    parser.add_argument(
        "--height", type=int, default=DEFAULT_1_STAGE_HEIGHT,
        help=f"Height of the generated video in pixels, should be divisible "
             f"by 32 (default: {DEFAULT_1_STAGE_HEIGHT}).",
    )
    parser.add_argument(
        "--width", type=int, default=DEFAULT_1_STAGE_WIDTH,
        help=f"Width of the generated video in pixels, should be divisible "
             f"by 32 (default: {DEFAULT_1_STAGE_WIDTH}).",
    )
    parser.add_argument(
        "--num-frames", type=int, default=DEFAULT_NUM_FRAMES,
        help=f"Number of frames to generate, num-frames = (8 x K) + 1 "
             f"(default: {DEFAULT_NUM_FRAMES}).",
    )
    parser.add_argument(
        "--frame-rate", type=float, default=DEFAULT_FRAME_RATE,
        help=f"Frame rate of the generated video (fps) (default: {DEFAULT_FRAME_RATE}).",
    )
    parser.add_argument(
        "--num-inference-steps", type=int, default=DEFAULT_NUM_INFERENCE_STEPS,
        help=f"Number of denoising steps (default: {DEFAULT_NUM_INFERENCE_STEPS}).",
    )
    parser.add_argument(
        "--image", dest="images", action=ImageAction, nargs=3,
        metavar=("PATH", "FRAME_IDX", "STRENGTH"), default=[],
        help="Image conditioning input: path, target frame index, and "
             "conditioning strength (all three required). Repeatable.",
    )
    parser.add_argument(
        "--lora", dest="lora", action=LoraAction, nargs="+",
        metavar=("PATH", "STRENGTH"), default=[],
        help=f"LoRA model: path and optional strength (default strength: "
             f"{DEFAULT_LORA_STRENGTH}). Repeatable.",
    )
    parser.add_argument(
        "--enable-fp8", action="store_true",
        help="Reference flag: keep the model in FP8 storage. No effect "
             "here (this build quantizes via --quantize-bits/W8A8 instead); "
             "accepted for CLI parity.",
    )
    parser.add_argument("--enhance-prompt", action="store_true")
    return parser


def default_1_stage_arg_parser() -> argparse.ArgumentParser:
    """basic + CFG flags (reference: args.py:188-211)."""
    parser = basic_arg_parser()
    parser.add_argument(
        "--cfg-guidance-scale", type=float, default=DEFAULT_CFG_GUIDANCE_SCALE,
        help=f"Classifier-free guidance scale (default: {DEFAULT_CFG_GUIDANCE_SCALE}).",
    )
    parser.add_argument(
        "--negative-prompt", type=str, default=DEFAULT_NEGATIVE_PROMPT,
        help="Negative prompt describing what should not appear in the video.",
    )
    return parser


def _set_2_stage_dims(parser: argparse.ArgumentParser) -> None:
    parser.set_defaults(height=DEFAULT_2_STAGE_HEIGHT, width=DEFAULT_2_STAGE_WIDTH)
    for action in parser._actions:
        if "--height" in action.option_strings:
            action.help = (
                f"Height of the generated video in pixels, should be "
                f"divisible by 64 (default: {DEFAULT_2_STAGE_HEIGHT})."
            )
        if "--width" in action.option_strings:
            action.help = (
                f"Width of the generated video in pixels, should be "
                f"divisible by 64 (default: {DEFAULT_2_STAGE_WIDTH})."
            )


def default_2_stage_arg_parser() -> argparse.ArgumentParser:
    """1-stage + required distilled-LoRA + upsampler (reference: args.py:214-252)."""
    parser = default_1_stage_arg_parser()
    _set_2_stage_dims(parser)
    parser.add_argument(
        "--distilled-lora", dest="distilled_lora", action=LoraAction, nargs="+",
        metavar=("PATH", "STRENGTH"), required=True,
        help="Distilled LoRA applied to the stage-2 (upscale + refinement) "
             "transformer: path and optional strength. Required.",
    )
    parser.add_argument(
        "--spatial-upsampler-path", type=resolve_path, required=True,
        help="Path to the spatial upsampler model used to increase the "
             "resolution of the generated video in the latent space.",
    )
    return parser


def default_2_stage_distilled_arg_parser() -> argparse.ArgumentParser:
    """basic (no CFG flags) + upsampler at 2-stage dims (reference: args.py:255-277)."""
    parser = basic_arg_parser()
    _set_2_stage_dims(parser)
    parser.add_argument(
        "--spatial-upsampler-path", type=resolve_path, required=True,
        help="Path to the spatial upsampler model used to increase the "
             "resolution of the generated video in the latent space.",
    )
    return parser


# --- Additive CLI helpers (this repo's pipeline mains) -------------------


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--prompt", required=True)
    parser.add_argument("--negative-prompt", default=None)
    parser.add_argument("--model-repo", default="Lightricks/LTX-2")
    parser.add_argument("--checkpoint-path", default=None,
                        help="Explicit checkpoint path (overrides --model-repo)")
    parser.add_argument("--gemma-root", default=None,
                        help="Text-encoder snapshot root")
    parser.add_argument("--spatial-upsampler-path", default=None,
                        help="Explicit 2x latent upsampler weights path")
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--num-frames", type=int, default=33)
    parser.add_argument("--num-inference-steps", type=int, default=None)
    parser.add_argument("--cfg-guidance-scale", type=float, default=None)
    parser.add_argument("--seed", type=int, default=10)
    parser.add_argument("--frame-rate", "--fps", type=float, default=24.0, dest="fps")
    parser.add_argument("--output-path", default="output.mp4")
    parser.add_argument("--enhance-prompt", action="store_true")
    parser.add_argument("--enable-fp8", action="store_true",
                        help="(parity) no effect; ignored")


def add_image_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--image", action="append", nargs="+", default=[],
        metavar="PATH [FRAME_IDX] [STRENGTH]",
    )


def add_video_conditioning_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--video-conditioning", action="append", nargs="+", default=[],
        metavar="PATH [FRAME_IDX] [STRENGTH]",
    )


def add_lora_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--lora", action="append", nargs="+", default=[],
                        metavar="PATH [STRENGTH]")
    parser.add_argument("--distilled-lora", action="append", nargs="+", default=[],
                        metavar="PATH [STRENGTH]",
                        help="LoRA applied to the stage-2 transformer copy")


def parse_tuple_args(values, defaults=(0, 1.0)):
    out = []
    for item in values:
        path = item[0]
        idx = int(item[1]) if len(item) > 1 else defaults[0]
        strength = float(item[2]) if len(item) > 2 else defaults[1]
        out.append((path, idx, strength))
    return out
