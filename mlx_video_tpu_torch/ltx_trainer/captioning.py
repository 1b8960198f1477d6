"""Captioning (reference: ltx_trainer/captioning.py ->
mlx_video/mlx_trainer/captioning.py:10-115).

Both reference class names resolve here and go through the port's
trainer/aux.py, which refuses captioning by name: it needs a captioning
model fetched from the network.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from mlx_video_tpu_torch.trainer.aux import caption_image, caption_video  # noqa: F401


@dataclass
class CaptionConfig:
    model_id: str = "Salesforce/blip-image-captioning-base"
    max_new_tokens: int = 64
    device: str = "cuda"


@dataclass
class MlxCaptionConfig:
    """Reference-name compat; maps onto the same backend."""

    model_id: str = "Salesforce/blip-image-captioning-base"
    max_tokens: int = 128
    temperature: float = 0.0
    prompt: str = "Describe the image."


class Captioner:
    """Frame -> caption."""

    def __init__(self, cfg: Optional[CaptionConfig] = None) -> None:
        self.cfg = cfg or CaptionConfig()

    def caption(self, frame: np.ndarray) -> str:
        return caption_image(
            frame, model_name=self.cfg.model_id, max_new_tokens=self.cfg.max_new_tokens
        )

    def caption_batch(self, frames: List[np.ndarray]) -> List[str]:
        return [self.caption(f) for f in frames]


class MlxCaptioner(Captioner):
    """Reference-name compat: the same backend."""

    def __init__(self, cfg: Optional[MlxCaptionConfig] = None) -> None:
        mcfg = cfg or MlxCaptionConfig()
        super().__init__(CaptionConfig(model_id=mcfg.model_id))


def get_captioner(backend: str, model_id: str, max_new_tokens: int = 64) -> Captioner:
    return Captioner(CaptionConfig(model_id=model_id, max_new_tokens=max_new_tokens))


__all__ = [
    "CaptionConfig",
    "Captioner",
    "MlxCaptionConfig",
    "MlxCaptioner",
    "caption_image",
    "caption_video",
    "get_captioner",
]
