"""Two-stage distilled pipeline wrapper with explicit stage-2 options
(reference: ltx_pipelines/ti2vid_two_stages.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

from mlx_video_tpu_torch.ltx_pipelines.bridge import TPUPipelineConfig, run_generate
from mlx_video_tpu_torch.pipelines.generate import PipelineType


@dataclass
class TI2VidTwoStages:
    model_repo: str = "Lightricks/LTX-2"
    text_encoder_repo: Optional[str] = None
    height: int = 1024
    width: int = 1536
    num_frames: int = 121
    stage1_steps: int = 8
    stage2_steps: int = 3
    seed: int = 10
    fps: float = 24.0
    audio: bool = False
    verbose: bool = False
    tiling: str = "auto"
    device: str = "cuda"

    def __call__(
        self,
        prompt: str,
        output_path: str = "output.mp4",
        images: Optional[Iterable] = None,
        distilled_lora: Optional[Iterable] = None,
        negative_prompt: Optional[str] = None,
    ) -> str:
        cfg = TPUPipelineConfig(
            model_repo=self.model_repo, text_encoder_repo=self.text_encoder_repo,
            height=self.height, width=self.width, num_frames=self.num_frames,
            steps=self.stage1_steps, seed=self.seed, fps=self.fps, audio=self.audio,
            verbose=self.verbose, tiling=self.tiling, device=self.device,
        )
        return run_generate(
            prompt=prompt, pipeline=PipelineType.DISTILLED, cfg=cfg,
            output_path=output_path, images=images, distilled_loras=distilled_lora,
            negative_prompt=negative_prompt,
        )


# Reference class name (reference: ltx_pipelines/ti2vid_two_stages.py)
TI2VidTwoStagesPipeline = TI2VidTwoStages


def main() -> None:
    """CLI entry (reference: per-pipeline main -> run_cli)."""
    from mlx_video_tpu_torch.ltx_pipelines.bridge import run_cli

    run_cli("distilled")


if __name__ == "__main__":
    main()
