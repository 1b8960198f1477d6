"""Lazy model registry (reference: ltx_pipelines/utils/model_ledger.py).

Resolves weight files and loads components on first access, caching them,
onto ``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import torch

from mlx_video_tpu_torch.loading import load_model_bundle
from mlx_video_tpu_torch.pipelines.generate import ModelBundle, PipelineType


class ModelLedger:
    """Lazy accessor over a model snapshot's components."""

    def __init__(
        self,
        model_path,
        pipeline: str = "distilled",
        audio: bool = False,
        loras: Optional[List[Tuple[str, float]]] = None,
        dtype=torch.bfloat16,
        device="cuda",
    ):
        self.model_path = Path(model_path)
        self.pipeline = PipelineType(pipeline)
        self.audio = audio
        self.loras = list(loras or [])
        self.dtype = dtype
        self.device = device
        self._bundle: Optional[ModelBundle] = None

    def with_loras(self, loras: List[Tuple[str, float]]) -> "ModelLedger":
        return ModelLedger(self.model_path, self.pipeline.value, self.audio, loras, self.dtype, self.device)

    @property
    def bundle(self) -> ModelBundle:
        if self._bundle is None:
            self._bundle = load_model_bundle(
                self.model_path, pipeline=self.pipeline, audio=self.audio, dtype=self.dtype, device=self.device
            )
            if self.loras:
                from mlx_video_tpu_torch.lora import LoraSpec, merge_lora_into_params

                merge_lora_into_params(self._bundle.transformer, [LoraSpec(Path(p), s) for p, s in self.loras])
        return self._bundle

    @property
    def transformer(self):
        return self.bundle.transformer

    @property
    def video_decoder(self):
        return self.bundle.vae_decoder

    @property
    def video_encoder(self):
        return self.bundle.vae_encoder

    @property
    def upsampler(self):
        return self.bundle.upsampler
