"""LoRA fusing (reference: ltx_core/loader/fuse_loras.py).

The reference module raises on use (its real merge lives in mlx_video.lora);
here ``fuse_loras`` merges, through the port's merge into the DiT module
(lora.py:merge_lora_into_params, in place).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable


def fuse_loras(params, loras: Iterable, verbose: bool = False):
    """Merge LoRA files into a DiT module (models/ltx/model.py:LTXModel);
    returns it.

    ``loras``: iterables of (path, strength) pairs or
    :class:`mlx_video_tpu_torch.ltx_core.loader.primitives.LoraPathStrengthAndSDOps`.
    """
    from mlx_video_tpu_torch.lora import LoraSpec, merge_lora_into_params

    specs = []
    for item in loras:
        if hasattr(item, "path"):
            specs.append(LoraSpec(Path(item.path), float(getattr(item, "strength", 1.0))))
        else:
            path, strength = item
            specs.append(LoraSpec(Path(path), float(strength)))
    return merge_lora_into_params(params, specs, verbose=verbose)


__all__ = ["fuse_loras"]
