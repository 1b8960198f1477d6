"""Validation sampling during training: one clip a prompt from the model
under training.

Counterpart of mlx_video_tpu/trainer/validation_sampler.py
(``ValidationSampler``): generate_video per prompt, ``stage1_steps =
min(steps, 8)``, no tiling, an image per prompt where given, and the text
from precomputed embeddings or a text encoder. The JAX sampler swaps the
trained params into its bundle; here the model is an ``nn.Module`` trained
in place, so the sampler runs the trainer's own module (its adapters
attached) in the module's dtype, in eval mode and without gradients, and
puts the module's training mode back afterwards. It draws only from
generate_video's generators (seeded with ``seed``), so a training run with
validation takes the same draws, losses and updates as one without.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence

import torch


class ValidationSampler:
    def __init__(
        self,
        models,
        text_encoder=None,
        output_dir: Path = Path("./validation"),
        prompts: Sequence[str] = (),
        negative_prompt: str = "",
        width: int = 512,
        height: int = 512,
        num_frames: int = 33,
        steps: int = 8,
        cfg_scale: float = 4.0,
        fps: float = 24.0,
        seed: int = 0,
        pipeline: str = "distilled",
        images: Optional[Sequence[str]] = None,
        precomputed_text=None,
    ):
        self.models = models
        self.text_encoder = text_encoder
        self.precomputed_text = precomputed_text
        self.output_dir = Path(output_dir)
        self.prompts = list(prompts)
        self.negative_prompt = negative_prompt
        self.width, self.height = width, height
        self.num_frames, self.steps = num_frames, steps
        self.cfg_scale, self.fps, self.seed = cfg_scale, fps, seed
        self.pipeline = pipeline
        self.images = list(images or [])

    def _text(self, i: int, prompt: str):
        from mlx_video_tpu_torch.pipelines.generate import TextConditioning

        if self.precomputed_text is not None:
            return self.precomputed_text[i] if isinstance(self.precomputed_text, list) else self.precomputed_text
        if self.text_encoder is None:
            raise ValueError("ValidationSampler needs a text encoder or precomputed text")
        video_emb, audio_emb = self.text_encoder.encode(prompt)
        neg = self.text_encoder.encode(self.negative_prompt)[0] if self.negative_prompt else None
        return TextConditioning(video_embeddings=video_emb, video_neg_embeddings=neg, audio_embeddings=audio_emb)

    def __call__(self, model: torch.nn.Module, step: int) -> List[Path]:
        """Generate one validation clip per prompt with ``model``; returns the
        mp4 paths (``step_{step}_prompt_{i}.mp4``)."""
        from mlx_video_tpu_torch.pipelines.generate import PipelineType, generate_video

        self.output_dir.mkdir(parents=True, exist_ok=True)
        models = dataclasses.replace(self.models, transformer=model)
        training = model.training
        model.eval()
        outputs = []
        try:
            with torch.no_grad():
                for i, prompt in enumerate(self.prompts):
                    out = self.output_dir / f"step_{step}_prompt_{i}.mp4"
                    generate_video(
                        models,
                        self._text(i, prompt),
                        height=self.height,
                        width=self.width,
                        num_frames=self.num_frames,
                        fps=self.fps,
                        seed=self.seed,
                        pipeline=PipelineType(self.pipeline),
                        stage1_steps=min(self.steps, 8),
                        num_inference_steps=self.steps,
                        cfg_scale=self.cfg_scale,
                        images=[(self.images[i], 0, 1.0)] if i < len(self.images) else [],
                        output_path=out,
                        tiling="none",
                        dtype=model.video.scale_shift_table.dtype,
                    )
                    outputs.append(out)
        finally:
            model.train(training)
        return outputs
