"""Distilled two-stage pipeline wrapper (reference: ltx_pipelines/distilled.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

from mlx_video_tpu_torch.ltx_pipelines.bridge import TPUPipelineConfig, run_generate
from mlx_video_tpu_torch.pipelines.generate import PipelineType


@dataclass
class DistilledPipeline:
    model_repo: str = "Lightricks/LTX-2"
    text_encoder_repo: Optional[str] = None
    height: int = 512
    width: int = 512
    num_frames: int = 33
    steps: int = 8
    seed: int = 42
    fps: float = 24.0
    audio: bool = False
    verbose: bool = False
    stream: bool = False
    tiling: str = "auto"
    device: str = "cuda"

    def _config(self) -> TPUPipelineConfig:
        return TPUPipelineConfig(
            model_repo=self.model_repo, text_encoder_repo=self.text_encoder_repo,
            height=self.height, width=self.width, num_frames=self.num_frames,
            steps=self.steps, cfg_scale=1.0, seed=self.seed, fps=self.fps,
            audio=self.audio, verbose=self.verbose, stream=self.stream, tiling=self.tiling, device=self.device,
        )

    def __call__(
        self,
        prompt: str,
        output_path: str = "output.mp4",
        images: Optional[Iterable] = None,
        distilled_lora: Optional[Iterable] = None,
        negative_prompt: Optional[str] = None,
    ) -> str:
        return run_generate(
            prompt=prompt, pipeline=PipelineType.DISTILLED, cfg=self._config(),
            output_path=output_path, images=images,
            distilled_loras=distilled_lora, negative_prompt=negative_prompt,
        )


def main() -> None:
    """CLI entry (reference: per-pipeline main -> run_cli)."""
    from mlx_video_tpu_torch.ltx_pipelines.bridge import run_cli

    run_cli("distilled")


if __name__ == "__main__":
    main()
