"""IC-LoRA video-conditioning pipeline wrapper (reference: ltx_pipelines/ic_lora.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

from mlx_video_tpu_torch.ltx_pipelines.bridge import TPUPipelineConfig, run_generate
from mlx_video_tpu_torch.pipelines.generate import PipelineType


@dataclass
class ICLoraPipeline:
    model_repo: str = "Lightricks/LTX-2"
    text_encoder_repo: Optional[str] = None
    height: int = 512
    width: int = 512
    num_frames: int = 33
    steps: int = 8
    seed: int = 42
    fps: float = 24.0
    verbose: bool = False
    tiling: str = "auto"
    device: str = "cuda"

    def __call__(
        self,
        prompt: str,
        video_conditionings: Iterable,
        output_path: str = "output.mp4",
        loras: Optional[Iterable] = None,
        negative_prompt: Optional[str] = None,
    ) -> str:
        cfg = TPUPipelineConfig(
            model_repo=self.model_repo, text_encoder_repo=self.text_encoder_repo,
            height=self.height, width=self.width, num_frames=self.num_frames,
            steps=self.steps, seed=self.seed, fps=self.fps, verbose=self.verbose,
            tiling=self.tiling, device=self.device, conditioning_mode="replace",
        )
        return run_generate(
            prompt=prompt, pipeline=PipelineType.IC_LORA, cfg=cfg,
            output_path=output_path, video_conditionings=video_conditionings,
            loras=loras, negative_prompt=negative_prompt,
        )


def main() -> None:
    """CLI entry (reference: per-pipeline main -> run_cli)."""
    from mlx_video_tpu_torch.ltx_pipelines.bridge import run_cli

    run_cli("ic_lora")


if __name__ == "__main__":
    main()
