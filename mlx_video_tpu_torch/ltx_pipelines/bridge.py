"""Bridge: the reference's pipeline wrappers -> the port's generate CLI.

Behavioral spec: reference ltx_pipelines/mlx_bridge.py (dataclass config,
argument normalization, run_generate forwarding into the engine). The argv
is the JAX bridge's, plus ``--device`` from the config (the card unless the
caller asks for the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from mlx_video_tpu_torch.pipelines.generate import PipelineType


@dataclass
class TPUPipelineConfig:
    model_repo: str = "Lightricks/LTX-2"
    text_encoder_repo: Optional[str] = None
    height: int = 512
    width: int = 512
    num_frames: int = 33
    steps: int = 40
    cfg_scale: float = 4.0
    seed: int = 42
    fps: float = 24.0
    audio: bool = False
    verbose: bool = False
    stream: bool = False
    tiling: str = "auto"
    conditioning_mode: str = "replace"
    device: str = "cuda"


# Reference-name alias (reference: ltx_pipelines/mlx_bridge.py MLXPipelineConfig)
MLXPipelineConfig = TPUPipelineConfig


def _ensure_list(value):
    return [] if value is None else list(value)


def normalize_loras(loras) -> List[Tuple[str, float]]:
    out = []
    for item in _ensure_list(loras):
        if isinstance(item, (list, tuple)) and len(item) == 2:
            out.append((str(item[0]), float(item[1])))
        elif isinstance(item, (list, tuple)) and len(item) == 1:
            out.append((str(item[0]), 1.0))
        else:
            out.append((str(item), 1.0))
    return out


def normalize_images(images) -> List[Tuple[str, int, float]]:
    out = []
    for item in _ensure_list(images):
        if isinstance(item, (list, tuple)) and len(item) == 3:
            out.append((str(item[0]), int(item[1]), float(item[2])))
        elif isinstance(item, (list, tuple)) and len(item) == 1:
            out.append((str(item[0]), 0, 1.0))
        else:
            out.append((str(item), 0, 1.0))
    return out


def normalize_video_conditions(video_conditionings) -> List[Tuple[str, int, float]]:
    out = []
    for item in _ensure_list(video_conditionings):
        if isinstance(item, (list, tuple)) and len(item) == 3:
            out.append((str(item[0]), int(item[1]), float(item[2])))
        elif isinstance(item, (list, tuple)) and len(item) == 2:
            out.append((str(item[0]), 0, float(item[1])))
        else:
            out.append((str(item), 0, 1.0))
    return out


def run_generate(
    prompt: str,
    pipeline: PipelineType,
    cfg: TPUPipelineConfig,
    output_path: str,
    images=None,
    video_conditionings=None,
    loras=None,
    distilled_loras=None,
    negative_prompt: Optional[str] = None,
) -> str:
    """Forward a wrapper invocation into the CLI-level engine entry
    (reference: mlx_bridge.py:77+)."""
    from mlx_video_tpu_torch.cli.generate import main as generate_main

    argv = [
        "--prompt", prompt,
        "--pipeline", pipeline.value,
        "--model-repo", cfg.model_repo,
        "--height", str(cfg.height),
        "--width", str(cfg.width),
        "--num-frames", str(cfg.num_frames),
        "--seed", str(cfg.seed),
        "--fps", str(cfg.fps),
        "--output-path", str(output_path),
        "--tiling", cfg.tiling,
        "--conditioning-mode", cfg.conditioning_mode,
    ]
    if pipeline == PipelineType.DEV:
        argv += ["--steps", str(cfg.steps), "--cfg-scale", str(cfg.cfg_scale)]
    else:
        argv += ["--stage1-steps", str(min(cfg.steps, 8))]
    if cfg.text_encoder_repo:
        argv += ["--text-encoder-path", cfg.text_encoder_repo]
    if cfg.audio:
        argv += ["--audio"]
    if cfg.stream:
        argv += ["--stream"]
    if negative_prompt:
        argv += ["--negative-prompt", negative_prompt]
    for path, idx, strength in normalize_images(images):
        argv += ["--image", path, str(idx), str(strength)]
    for path, idx, strength in normalize_video_conditions(video_conditionings):
        argv += ["--video-conditioning", path, str(idx), str(strength)]
    for path, strength in normalize_loras(loras):
        argv += ["--lora", path, "--lora-strength", str(strength)]
    for path, _strength in normalize_loras(distilled_loras):
        argv += ["--distilled-lora", path]
    argv += ["--device", cfg.device]

    generate_main(argv)
    return str(output_path)


def run_cli(default_pipeline: str) -> None:
    """Dispatch to the generate CLI with a default pipeline
    (reference: ltx_pipelines/mlx_bridge.py:115-121)."""
    import sys

    if "--pipeline" not in sys.argv:
        sys.argv.extend(["--pipeline", default_pipeline])
    from mlx_video_tpu_torch.cli.generate import main as _main

    _main()
