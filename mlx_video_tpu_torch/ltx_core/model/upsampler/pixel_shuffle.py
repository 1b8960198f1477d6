"""Pixel shuffle (reference: ltx_core/model/upsampler/pixel_shuffle.py).
Channels-first here: (N, C*r*r, H, W) -> (N, C, H*r, W*r) in torch
PixelShuffle channel order, as the engine's ``spatial_upsample_2x`` runs it."""

import torch
import torch.nn.functional as F


def pixel_shuffle_2d(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    return F.pixel_shuffle(x, r)


__all__ = ["pixel_shuffle_2d"]
