"""Loader primitives (reference: ltx_core/loader/primitives.py)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping, Optional


@dataclass
class LoraPathStrengthAndSDOps:
    """A LoRA file + strength (+ optional state-dict ops), as the reference's
    loader passes them around (reference: ltx_core/loader/primitives.py)."""

    path: Path
    strength: float = 1.0
    sd_ops: Optional[Any] = None

    def __post_init__(self):
        self.path = Path(self.path)


__all__ = ["LoraPathStrengthAndSDOps"]
