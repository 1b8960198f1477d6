"""Safetensors state-dict loader (reference: ltx_core/loader/sft_loader.py,
a raise/no-op stub there; it reads here, through io/safetensors.py)."""

from __future__ import annotations

from pathlib import Path

from mlx_video_tpu_torch.ltx_core.utils import device_or_card


class SafetensorsModelStateDictLoader:
    """Loads raw tensors from a safetensors file as a flat state dict, on
    ``device`` (the card when None)."""

    def __init__(self, path):
        self.path = Path(path)

    def load(self, device=None) -> dict:
        from mlx_video_tpu_torch.io.safetensors import SafetensorsReader

        device = device_or_card(device)
        with SafetensorsReader(self.path) as r:
            return {name: r.get(name, device=device) for name in r.keys()}


__all__ = ["SafetensorsModelStateDictLoader"]
