"""Single-stage dev CFG pipeline wrapper (reference: ltx_pipelines/ti2vid_one_stage.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

from mlx_video_tpu_torch.ltx_pipelines.bridge import TPUPipelineConfig, run_generate
from mlx_video_tpu_torch.pipelines.generate import PipelineType


@dataclass
class TI2VidOneStage:
    model_repo: str = "Lightricks/LTX-2"
    text_encoder_repo: Optional[str] = None
    height: int = 512
    width: int = 768
    num_frames: int = 121
    steps: int = 40
    cfg_scale: float = 4.0
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
        loras: Optional[Iterable] = None,
        negative_prompt: Optional[str] = None,
    ) -> str:
        cfg = TPUPipelineConfig(
            model_repo=self.model_repo, text_encoder_repo=self.text_encoder_repo,
            height=self.height, width=self.width, num_frames=self.num_frames,
            steps=self.steps, cfg_scale=self.cfg_scale, seed=self.seed, fps=self.fps,
            audio=self.audio, verbose=self.verbose, tiling=self.tiling, device=self.device,
        )
        return run_generate(
            prompt=prompt, pipeline=PipelineType.DEV, cfg=cfg, output_path=output_path,
            images=images, loras=loras, negative_prompt=negative_prompt,
        )


# Reference class name (reference: ltx_pipelines/ti2vid_one_stage.py)
TI2VidOneStagePipeline = TI2VidOneStage


def main() -> None:
    """CLI entry (reference: per-pipeline main -> run_cli)."""
    from mlx_video_tpu_torch.ltx_pipelines.bridge import run_cli

    run_cli("dev")


if __name__ == "__main__":
    main()
