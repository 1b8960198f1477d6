"""Plain PyTorch reference of the dev pipeline's pieces: the ``ltx2_scheduler``
schedule, the VAE encoder that turns the conditioning image into its clean
latent, and a slice of classifier-free-guided denoise steps with the
replace-mode conditioning blend.

Like portbench/reference/ltx_video.py (whose DiT it runs) it imports torch
and numpy only and reads the benchmark's drawn tensors by name; its
arithmetic follows the port's pipelines/denoise.py, pipelines/conditioning.py,
pipelines/schedulers.py and models/ltx/video_vae/encoder.py at commit
c91ea08. ``lowp=True`` rounds the operands of every linear and convolution
to float8 e4m3: the control.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.ltx_video import DiT, _bias_add, _operands, pixel_norm

STRIDES = {"compress_all_res": (2, 2, 2), "compress_space_res": (1, 2, 2), "compress_time_res": (2, 1, 1)}


def ltx2_scheduler(steps: int, num_tokens: int, max_shift: float = 2.05, base_shift: float = 0.95,
                   terminal: float = 0.1) -> np.ndarray:
    """The dev schedule: a token-count shift of linspace(1, 0), then the
    non-zero sigmas stretched so the last one is ``terminal``; fp32."""
    tokens = min(num_tokens, 4096)
    sigmas = np.linspace(1.0, 0.0, steps + 1)
    mm = (max_shift - base_shift) / (4096 - 1024)
    shift = tokens * mm + (base_shift - mm * 1024)
    out = np.zeros_like(sigmas)
    nz = sigmas != 0
    out[nz] = math.exp(shift) / (math.exp(shift) + (1 / sigmas[nz] - 1))
    nz = out != 0
    one_minus = 1.0 - out[nz]
    scale = one_minus[-1] / (1.0 - terminal)
    if np.isfinite(scale) and scale != 0:
        out[nz] = 1.0 - one_minus / scale
    return out.astype(np.float32)


# -- the VAE encoder -------------------------------------------------------------

def causal_conv(w, name: str, x: torch.Tensor, stride=(1, 1, 1), lowp: bool = False) -> torch.Tensor:
    """3x3x3 conv: the first frame repeated twice in front, zero padding of H
    and W, bias added in fp32."""
    x = torch.cat([x[:, :, :1], x[:, :, :1], x], dim=2)
    x = F.pad(x, (1, 1, 1, 1, 0, 0))
    xi, wt = _operands(x, w[name + ".weight"], lowp)
    return _bias_add(F.conv3d(xi, wt, stride=stride), w[name + ".bias"], x.dtype)


def space_to_depth(x: torch.Tensor, st: int, sh: int, sw: int) -> torch.Tensor:
    b, c, d, h, wd = x.shape
    x = x.reshape(b, c, d // st, st, h // sh, sh, wd // sw, sw).permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, c * st * sh * sw, d // st, h // sh, wd // sw)


def encode(w: Dict[str, torch.Tensor], ecfg: dict, pixels: torch.Tensor, lowp: bool = False) -> torch.Tensor:
    """(B, 3, 1 + 8k, H, W) pixels in [-1, 1] to the normalised latent means
    (B, C, 1 + k, H/32, W/32), in the pixels' dtype."""
    p = ecfg["patch_size"]
    b, c, f, h, wd = pixels.shape
    x = pixels.reshape(b, c, f, 1, h // p, p, wd // p, p).permute(0, 1, 3, 7, 5, 2, 4, 6)
    x = x.reshape(b, c * p * p, f, h // p, wd // p)
    x = causal_conv(w, "conv_in", x, lowp=lowp)
    feat = ecfg["out_channels"]
    for i, (name, bcfg) in enumerate(ecfg["blocks"]):
        pre = f"down_blocks.{i}"
        if name == "res_x":
            for j in range(bcfg["num_layers"]):
                r = f"{pre}.res_blocks.{j}"
                h1 = causal_conv(w, r + ".conv1", F.silu(pixel_norm(x, 1e-6)), lowp=lowp)
                x = causal_conv(w, r + ".conv2", F.silu(pixel_norm(h1, 1e-6)), lowp=lowp) + x
            continue
        st, sh, sw = STRIDES[name]
        out = feat * bcfg.get("multiplier", 2)
        if st == 2:
            x = torch.cat([x[:, :, :1], x], dim=2)
        d, hh, ww = x.shape[2:]
        pads = ((sw - ww % sw) % sw, (sh - hh % sh) % sh, (st - d % st) % st)
        if any(pads):
            x = F.pad(x, (0, pads[0], 0, pads[1], 0, pads[2]))
        skip = space_to_depth(x, st, sh, sw)
        skip = skip.reshape(skip.shape[0], out, -1, *skip.shape[2:]).mean(dim=2)
        x = space_to_depth(causal_conv(w, pre + ".conv", x, lowp=lowp), st, sh, sw) + skip
        feat = out
    x = causal_conv(w, "conv_out", F.silu(pixel_norm(x, 1e-6)), lowp=lowp)[:, :ecfg["out_channels"]]
    mean = w["per_channel_statistics.mean"].float().reshape(1, -1, 1, 1, 1)
    std = w["per_channel_statistics.std"].float().reshape(1, -1, 1, 1, 1)
    return ((x.float() - mean) / std).to(x.dtype)


# -- a slice of guided steps ---------------------------------------------------------

def cfg_slice(dit: DiT, latents: torch.Tensor, clean: torch.Tensor, mask: torch.Tensor, context: torch.Tensor,
              neg_context: torch.Tensor, sigmas: Sequence[float], cfg_scale: float) -> torch.Tensor:
    """Guided Euler steps over ``sigmas`` from (B, C, F, H, W) ``latents``:
    one forward of the doubled batch a step (context, then the negative),
    a token's sigma times its frame's denoise mask, v = v+ + (s - 1)(v+ - v-),
    x0 = x - sigma v blended with the clean latent by the mask, an fp32
    Euler step."""
    b, c, f, h, w = latents.shape
    dt = latents.dtype
    pe = dit.tables(2 * b, f, h, w, latents.device)
    ctx = torch.cat([context, neg_context], dim=0)
    v_mask = mask.reshape(b, 1, f, 1, 1).expand(b, 1, f, h, w).reshape(b, f * h * w).to(dt)
    m = mask.to(dt)
    sig = [float(s) for s in np.asarray(sigmas, dtype=np.float32)]
    for sigma, nxt in zip(sig[:-1], sig[1:]):
        tokens = latents.reshape(b, c, -1).transpose(1, 2)
        ts = (sigma * v_mask).to(dt)
        vel = dit.forward(torch.cat([tokens, tokens]), torch.cat([ts, ts]), ctx, pe)
        pos, neg = vel.chunk(2, dim=0)
        vel = (pos + (cfg_scale - 1.0) * (pos - neg)).transpose(1, 2).reshape(latents.shape)
        den = (latents.float() - sigma * vel.float()).to(dt)
        den = den * m + clean.to(dt) * (1.0 - m)
        lat, den = latents.float(), den.float()
        latents = (den + nxt * (lat - den) / sigma).to(dt)
    return latents
