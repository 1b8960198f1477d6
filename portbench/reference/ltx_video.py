"""Plain PyTorch reference of the LTX-2 video stream's distilled pipeline.

The benchmark's own yardstick: it imports torch and numpy only, never the
program, and reads the weights from the dict that the benchmark drew
(portbench/weights.py), under the checkpoint's names. It recomputes what the
program's timed path produces for one call of ``generate_video`` (distilled,
``num_videos`` N): the stage-1 denoise at half size, the 2x latent upsample,
the renoise and the stage-2 refine, then one untiled VAE decode a video.

The arithmetic follows the model's published definition as the port computes
it (models/ltx/model.py, pipelines/denoise.py, pipelines/generate.py,
models/ltx/upsampler.py and video_vae/ at commit c91ea08): bf16 tensors with
fp32 islands at the timestep sinusoids, the RoPE tables and rotation, the
norms, the cross-attention softmax, the Euler step and the latent
statistics. Self-attention is ``F.scaled_dot_product_attention`` and every
linear is ``F.linear`` on the weight (a 4-bit weight is dequantized here
first), where the program runs its own kernels (K1, K2) and cuBLAS.

``lowp=True`` is the control: every DiT linear and every convolution of the
upsampler and the decoder takes both operands rounded to float8 e4m3 (one
scale a tensor), the nearest precision below the bf16 that the
configuration states (below its bf16 activations, for the 4-bit one).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

STAGE_1_SIGMAS = [1.0, 0.99375, 0.9875, 0.98125, 0.975, 0.909375, 0.725, 0.421875, 0.0]
STAGE_2_SIGMAS = [0.909375, 0.725, 0.421875, 0.0]
SPATIAL_SCALE, TEMPORAL_SCALE = 32, 8
FP8_MAX = 448.0


# -- schedules and positions -------------------------------------------------

def farthest_sigmas(sigmas: Sequence[float], steps: int) -> List[float]:
    """Farthest-point subsampling of a schedule in log-sigma space."""
    if steps >= len(sigmas) - 1:
        return list(sigmas)
    if steps == 1:
        return [sigmas[0], sigmas[-1]]
    pool = sigmas[:-1]
    xs = [math.log(max(s, 1e-6)) for s in pool]
    chosen = {0, len(pool) - 1}
    while len(chosen) < steps:
        best, score = None, -1.0
        for i in range(len(pool)):
            if i not in chosen:
                d = min(abs(xs[i] - xs[j]) for j in chosen)
                if d > score:
                    best, score = i, d
        chosen.add(best)
    return [sigmas[i] for i in sorted(chosen)] + [sigmas[-1]]


def refinement_sigmas(steps: int) -> List[float]:
    if steps == 1:
        return [STAGE_2_SIGMAS[-2], STAGE_2_SIGMAS[-1]]
    return farthest_sigmas(STAGE_2_SIGMAS, steps)


def position_grid(batch: int, frames: int, height: int, width: int, fps: float = 24.0) -> torch.Tensor:
    """(B, 3, F*H*W, 2) pixel-space [start, end) bounds of the latent tokens,
    the time axis causally shifted and in seconds."""
    t, h, w = np.meshgrid(np.arange(frames), np.arange(height), np.arange(width), indexing="ij")
    starts = np.stack([t, h, w], axis=0)
    coords = np.stack([starts, starts + 1], axis=-1).reshape(3, frames * height * width, 2)
    coords = np.tile(coords[None], (batch, 1, 1, 1))
    pixel = (coords * np.array([TEMPORAL_SCALE, SPATIAL_SCALE, SPATIAL_SCALE]).reshape(1, 3, 1, 1)).astype(np.float32)
    pixel[:, 0] = np.clip(pixel[:, 0] + 1 - TEMPORAL_SCALE, 0, None) / fps
    return torch.from_numpy(pixel)


def split_rope_tables(positions: torch.Tensor, dim: int, heads: int, theta: float, max_pos: Sequence[int]):
    """(cos, sin) of shape (B, H, S, D/2), fp32: log-spaced frequencies over
    the middles of the positions, scaled to [-1, 1] by ``max_pos``, front
    padded with cos 1 / sin 0."""
    n_dims = positions.shape[1]
    n = max(dim // (2 * n_dims), 1)
    lin = torch.arange(n, dtype=torch.float32, device=positions.device)
    if n > 1:
        lin = lin * torch.tensor(1.0 / (n - 1), dtype=torch.float32, device=positions.device)
        lin[-1] = 1.0
    grid = torch.pow(torch.tensor(theta, dtype=torch.float64, device=positions.device), lin.double()).float()
    indices = grid * (math.pi / 2)
    mid = (positions.float()[..., 0] + positions.float()[..., 1]) * 0.5
    scale = torch.tensor(list(max_pos), dtype=torch.float32, device=positions.device).reshape(1, -1, 1)
    scaled = torch.movedim(mid / scale, 1, -1) * 2.0 - 1.0
    freqs = (scaled[..., None] * indices).transpose(-1, -2)
    freqs = freqs.reshape(freqs.shape[0], freqs.shape[1], -1)
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    pad = dim // 2 - freqs.shape[-1]
    if pad:
        shape = (*cos.shape[:-1], pad)
        cos = torch.cat([torch.ones(shape, device=cos.device), cos], dim=-1)
        sin = torch.cat([torch.zeros(shape, device=sin.device), sin], dim=-1)
    b, s = cos.shape[:2]
    return (cos.reshape(b, s, heads, -1).transpose(1, 2), sin.reshape(b, s, heads, -1).transpose(1, 2))


# -- DiT ---------------------------------------------------------------------

def dequantize(words: torch.Tensor, scales: torch.Tensor, biases: torch.Tensor, bits: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Group-affine words (out, in*bits/32), low bits first in each int32,
    to an (out, in) weight: q * scale + bias in fp32, rounded once."""
    per = 32 // bits
    shifts = (torch.arange(per, dtype=torch.int32, device=words.device) * bits)[None, None, :]
    q = ((words[..., None] >> shifts) & ((1 << bits) - 1)).reshape(words.shape[0], -1).float()
    groups = scales.shape[1]
    q = q.reshape(words.shape[0], groups, -1)
    return (q * scales.float()[..., None] + biases.float()[..., None]).reshape(words.shape[0], -1).to(dtype)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its absmax to 448), in
    its own dtype; a gradient passes straight through the rounding."""
    with torch.no_grad():
        tf = t.float()
        s = tf.abs().amax().clamp_min(1e-12) / FP8_MAX
        low = ((tf / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)
    return low if not t.requires_grad else t + (low - t).detach()


class DiT:
    """The video DiT's forward over the weight dict ``w`` (names as the
    checkpoint's: ``blocks.3.attn1.to_q.weight``; a 4-bit linear holds
    ``quant_weight``, ``scales`` and ``biases`` in place of ``weight``)."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: dict, lowp: bool = False, lora=None,
                 lora_scale: float = 1.0, remat: bool = False):
        self.w, self.cfg, self.lowp = w, cfg, lowp
        self.lora, self.lora_scale, self.remat = lora or {}, lora_scale, remat
        self.heads = cfg["num_attention_heads"]
        self.dim = self.heads * cfg["attention_head_dim"]
        self.eps = cfg["norm_eps"]
        q = cfg.get("quant") or {}
        self.bits = q.get("bits")

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """``F.linear`` with the bias fused for a dense weight; a 4-bit one is
        dequantized to x's dtype and takes its bias after the product."""
        bias = self.w.get(name + ".bias")
        dense = self.w.get(name + ".weight")
        wt = dense if dense is not None else dequantize(
            self.w[name + ".quant_weight"], self.w[name + ".scales"], self.w[name + ".biases"], self.bits, x.dtype)
        if self.lowp:
            x, wt = fp8_round(x), fp8_round(wt)
        if dense is not None:
            y = F.linear(x, wt, bias)
        else:
            y = F.linear(x, wt)
            y = y if bias is None else y + bias.to(y.dtype)
        if name not in self.lora:
            return y
        a, b = self.lora[name]  # LoRA: scale (x A^T) B^T in fp32, cast to y's dtype
        return y + ((x.float() @ a.float().T) @ b.float().T * self.lora_scale).to(y.dtype)

    def rms(self, x: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float()
        out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + self.eps)
        if weight is not None:
            out = out * weight.float()
        return out.to(x.dtype)

    def rope(self, x: torch.Tensor, pe) -> torch.Tensor:
        cos, sin = pe
        b, h, s, _ = cos.shape
        xf = x.reshape(b, s, h, -1).float()
        first, second = xf.chunk(2, dim=-1)
        c, sn = cos.float().transpose(1, 2), sin.float().transpose(1, 2)
        out = torch.cat([first * c - sn * second, second * c + sn * first], dim=-1)
        return out.to(x.dtype).reshape(x.shape)

    def attention(self, name: str, x: torch.Tensor, context: Optional[torch.Tensor] = None, pe=None, bias=None):
        ctx = x if context is None else context
        q = self.rms(self.linear(name + ".to_q", x), self.w[name + ".q_norm.weight"])
        k = self.rms(self.linear(name + ".to_k", ctx), self.w[name + ".k_norm.weight"])
        v = self.linear(name + ".to_v", ctx)
        b, sq, dim = q.shape
        skv, d = k.shape[1], dim // self.heads
        scale = d ** -0.5
        if pe is not None:
            q, k = self.rope(q, pe), self.rope(k, pe)
        qh = q.reshape(b, sq, self.heads, d)
        kh = k.reshape(b, skv, self.heads, d)
        vh = v.reshape(b, skv, self.heads, d)
        if context is None:
            out = F.scaled_dot_product_attention(qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2),
                                                 scale=scale).transpose(1, 2)
        else:  # fp32 logits and softmax, probabilities in v's dtype
            logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * scale
            if bias is not None:
                logits = logits + bias.float()
            probs = torch.softmax(logits, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, vh)
        return self.linear(name + ".to_out", out.reshape(b, sq, dim))

    def adaln(self, prefix: str, t_scaled: torch.Tensor, dtype):
        half = 128
        exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t_scaled.device) / half
        emb = t_scaled.float()[:, None] * torch.exp(exponent)[None, :]
        proj = torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1).to(dtype)
        te = prefix + ".emb.timestep_embedder"
        embedded = self.linear(te + ".linear2", F.silu(self.linear(te + ".linear1", proj)))
        return self.linear(prefix + ".linear", F.silu(embedded)), embedded

    def block(self, i: int, x: torch.Tensor, mod: torch.Tensor, ctx: torch.Tensor, pe, bias) -> torch.Tensor:
        p = f"blocks.{i}"
        table = self.w[p + ".scale_shift_table"]
        shift, scale, gate = (table[j][None, None, :] + mod[:, :, j, :] for j in range(3))
        a1 = self.attention(p + ".attn1", self.rms(x) * (1 + scale) + shift, pe=pe)
        x = x + a1 * gate
        x = x + self.attention(p + ".attn2", self.rms(x), context=ctx, bias=bias)
        shift, scale, gate = (table[j][None, None, :] + mod[:, :, j, :] for j in range(3, 6))
        h = self.rms(x) * (1 + scale) + shift
        h = self.linear(p + ".ff.proj_out", F.gelu(self.linear(p + ".ff.proj_in", h), approximate="tanh"))
        return x + h * gate

    def forward(self, tokens: torch.Tensor, ts: torch.Tensor, context: torch.Tensor, pe,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Velocities (B, S, C) of latent tokens (B, S, C) at sigmas ``ts``
        (B, 1) shared by a row's tokens or (B, S) one a token, in the tokens'
        dtype; ``context`` (B, L, caption_channels); ``context_mask`` (B, L)
        bool masks caption positions out of the text attention (an additive
        -1e9 in the tokens' dtype). With ``remat`` each block runs under
        ``torch.utils.checkpoint``."""
        w, dt, b = self.w, tokens.dtype, tokens.shape[0]
        x = self.linear("video.patchify_proj", tokens)
        t_scaled = ts * self.cfg["timestep_scale_multiplier"]
        mod, embedded = self.adaln("video.adaln_single", t_scaled.reshape(-1), dt)
        mod = mod.reshape(b, -1, 6, self.dim)
        embedded = embedded.reshape(b, -1, self.dim)
        ctx = self.linear("video.caption_projection.linear2",
                          F.gelu(self.linear("video.caption_projection.linear1", context), approximate="tanh"))
        bias = None
        if context_mask is not None:
            bias = ((context_mask.to(dt) - 1.0) * 1e9).reshape(b, 1, 1, -1)
        for i in range(self.cfg["num_layers"]):
            if self.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(self.block, i, x, mod, ctx, pe, bias, use_reentrant=False)
            else:
                x = self.block(i, x, mod, ctx, pe, bias)
        table = w["video.scale_shift_table"]
        shift, scale = table[0][None, None, :] + embedded, table[1][None, None, :] + embedded
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
        x = ((xf - mean) * torch.rsqrt(var + self.eps)).to(dt) * (1 + scale) + shift
        return self.linear("video.proj_out", x)

    def tables(self, batch: int, frames: int, h: int, w: int, device):
        cfg = self.cfg
        return split_rope_tables(position_grid(batch, frames, h, w).to(device), self.dim, self.heads,
                                 cfg["positional_embedding_theta"], cfg["positional_embedding_max_pos"])


def denoise(dit: DiT, latents: torch.Tensor, context: torch.Tensor, sigmas: Sequence[float]) -> torch.Tensor:
    """The distilled loop over (B, C, F, H, W) latents: x0 = x - sigma v,
    then an fp32 Euler step."""
    b, c, f, h, w = latents.shape
    pe = dit.tables(b, f, h, w, latents.device)
    sig = [float(s) for s in np.asarray(sigmas, dtype=np.float32)]
    for sigma, nxt in zip(sig[:-1], sig[1:]):
        tokens = latents.reshape(b, c, -1).transpose(1, 2)
        ts = torch.full((b, 1), sigma, dtype=torch.float32, device=latents.device).to(latents.dtype)
        vel = dit.forward(tokens, ts, context, pe).transpose(1, 2).reshape(latents.shape)
        den = (latents.float() - sigma * vel.float()).to(latents.dtype)
        lat, den = latents.float(), den.float()
        latents = (den + nxt * (lat - den) / sigma).to(latents.dtype)
    return latents


# -- convolutions: upsampler and decoder -------------------------------------

def _bias_add(out: torch.Tensor, bias: torch.Tensor, dtype) -> torch.Tensor:
    return (out.float() + bias.float().reshape(1, -1, *([1] * (out.dim() - 2)))).to(dtype)


def group_norm(w, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.group_norm(x.float(), 32, w[name + ".weight"].float(), w[name + ".bias"].float(), eps).to(x.dtype)


def _operands(x: torch.Tensor, wt: torch.Tensor, lowp: bool):
    wt = wt.to(x.dtype)
    return (fp8_round(x), fp8_round(wt)) if lowp else (x, wt)


def conv3d_same(w, name: str, x: torch.Tensor, lowp: bool = False) -> torch.Tensor:
    xi, wt = _operands(x, w[name + ".weight"], lowp)
    return _bias_add(F.conv3d(xi, wt, padding=1), w[name + ".bias"], x.dtype)


def upsample(w: Dict[str, torch.Tensor], latents: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
             blocks: int, lowp: bool = False) -> torch.Tensor:
    """De-normalise, the 2x latent upsampler, re-normalise (latent dtype)."""
    mean = mean.reshape(1, -1, 1, 1, 1).to(latents.dtype)
    std = std.reshape(1, -1, 1, 1, 1).to(latents.dtype)
    x = latents * std + mean

    def res(p, x):
        h = F.silu(group_norm(w, p + ".norm1", conv3d_same(w, p + ".conv1", x, lowp)))
        h = group_norm(w, p + ".norm2", conv3d_same(w, p + ".conv2", h, lowp))
        return F.silu(h + x)

    x = F.silu(group_norm(w, "initial_norm", conv3d_same(w, "initial_conv", x, lowp)))
    for i in range(blocks):
        x = res(f"res_blocks.{i}", x)
    b, c, f, h, wd = x.shape
    x2 = x.transpose(1, 2).reshape(b * f, c, h, wd)
    x2, wt = _operands(x2, w["upsampler.conv.weight"], lowp)
    x2 = F.conv2d(x2, wt, w["upsampler.conv.bias"].to(x.dtype), padding=1)
    x = F.pixel_shuffle(x2, 2).reshape(b, f, c, 2 * h, 2 * wd).transpose(1, 2)
    for i in range(blocks):
        x = res(f"post_upsample_res_blocks.{i}", x)
    up = conv3d_same(w, "final_conv", x, lowp)
    return (up - mean) / std


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, dim=1, keepdim=True) + eps)).to(x.dtype)


def conv3d_reflect(w, name: str, x: torch.Tensor, lowp: bool = False) -> torch.Tensor:
    """3x3x3 conv: first and last frames repeated once in time, reflect
    padding of H and W, bias added in fp32."""
    x = torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)
    x = F.pad(x, (1, 1, 1, 1, 0, 0), mode="reflect")
    xi, wt = _operands(x, w[name + ".weight"], lowp)
    return _bias_add(F.conv3d(xi, wt), w[name + ".bias"], x.dtype)


def _time_embed(w, name: str, t: torch.Tensor, dtype) -> torch.Tensor:
    half = 128
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    proj = torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1).to(dtype)
    h = F.silu(F.linear(proj, w[name + ".linear_1.weight"], w[name + ".linear_1.bias"]))
    return F.linear(h, w[name + ".linear_2.weight"], w[name + ".linear_2.bias"])


def depth_to_space(x: torch.Tensor, st: int, sh: int, sw: int) -> torch.Tensor:
    b, cm, d, h, wd = x.shape
    c = cm // (st * sh * sw)
    x = x.reshape(b, c, st, sh, sw, d, h, wd).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, c, d * st, h * sh, wd * sw)


def decode(w: Dict[str, torch.Tensor], dcfg: dict, latents: torch.Tensor, noise: torch.Tensor,
           lowp: bool = False) -> torch.Tensor:
    """One video's (1, C, F', H', W') latents to (1, 3, F, H, W) fp32 RGB:
    the decode noise mixed in, the latent statistics undone, the
    timestep-conditioned decoder run whole (no tiling)."""
    dt, s = latents.dtype, dcfg["decode_noise_scale"]
    x = noise.to(dt) * s + (1.0 - s) * latents
    x = (x.float() * w["latents_std"].float().reshape(1, -1, 1, 1, 1)
         + w["latents_mean"].float().reshape(1, -1, 1, 1, 1)).to(dt)
    t = torch.full((1,), dcfg["decode_timestep"] * 1000.0, dtype=torch.float32, device=x.device)
    chans = [dcfg["base_channels"] // 2 ** i for i in range(dcfg["num_upsamples"] + 1)]
    x = conv3d_reflect(w, "conv_in", x, lowp)
    for g, c in enumerate(chans):
        p = f"up_blocks.{2 * g}"
        emb = _time_embed(w, p + ".time_embedder", t, dt).reshape(1, 4, c)
        for j in range(dcfg["num_layers_per_block"]):
            r = f"{p}.res_blocks.{j}"
            ada = w[r + ".scale_shift_table"][None] + emb
            shift1, scale1, shift2, scale2 = (ada[:, i, :, None, None, None] for i in range(4))
            h = pixel_norm(x) * (1 + scale1) + shift1
            h = conv3d_reflect(w, r + ".conv1", F.silu(h), lowp)
            h = pixel_norm(h) * (1 + scale2) + shift2
            x = conv3d_reflect(w, r + ".conv2", F.silu(h), lowp) + x
        if g < dcfg["num_upsamples"]:
            h = depth_to_space(conv3d_reflect(w, f"up_blocks.{2 * g + 1}.conv", x, lowp), 2, 2, 2)[:, :, 1:]
            res = depth_to_space(x, 2, 2, 2).repeat(1, 4, 1, 1, 1)[:, :, 1:]
            x = h + res
    x = pixel_norm(x)
    emb = _time_embed(w, "last_time_embedder", t, dt).reshape(1, 2, chans[-1])
    ada = w["last_scale_shift_table"][None] + emb
    x = x * (1 + ada[:, 1, :, None, None, None]) + ada[:, 0, :, None, None, None]
    x = conv3d_reflect(w, "conv_out", F.silu(x), lowp)
    p = dcfg["patch_size"]
    b, cm, f, h, wd = x.shape
    x = x.reshape(b, cm // (p * p), p, p, f, h, wd).permute(0, 1, 4, 5, 3, 6, 2)
    return x.reshape(b, cm // (p * p), f, h * p, wd * p).float()


# -- the distilled call ------------------------------------------------------

def distilled(weights: Dict[str, Dict[str, torch.Tensor]], cfg: dict, traffic: dict, context: torch.Tensor,
              seeds: Sequence[int], device, lowp: bool = False) -> dict:
    """One distilled ``generate_video`` call over ``len(seeds)`` videos;
    video i draws its noise from a generator on ``device`` seeded with
    ``seeds[i]``: stage-1 noise, stage-2 noise, decode noise, in that order.
    Returns {"latents": (N, C, F, H, W) fp32, "video": (N, 3, F, H, W) fp32},
    both on the host."""
    dit = DiT(weights["dit"], cfg, lowp=lowp)
    dt = torch.bfloat16
    n = len(seeds)
    gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]
    c = cfg["in_channels"]
    frames = 1 + (traffic["num_frames"] - 1) // TEMPORAL_SCALE
    lh, lw = traffic["height"] // SPATIAL_SCALE, traffic["width"] // SPATIAL_SCALE

    def noise(shape):
        return torch.cat([torch.randn((1, *shape[1:]), generator=g, device=device, dtype=torch.float32)
                          for g in gens]).to(dt)

    ctx = context.to(device=device, dtype=dt).expand(n, -1, -1)
    s1 = farthest_sigmas(STAGE_1_SIGMAS, traffic["stage1_steps"])
    s2 = refinement_sigmas(traffic["stage2_steps"])
    lat = denoise(dit, noise((n, c, frames, lh // 2, lw // 2)), ctx, s1)
    dec = weights["decoder"]
    lat = upsample(weights["upsampler"], lat, dec["latents_mean"].to(device), dec["latents_std"].to(device),
                   cfg["upsampler"]["num_blocks"], lowp)
    sigma0 = s2[0]
    lat = noise(lat.shape) * sigma0 + lat * (1.0 - sigma0)
    lat = denoise(dit, lat, ctx, s2)
    videos = []
    for i, g in enumerate(gens):
        one = lat[i:i + 1]
        videos.append(decode(dec, cfg["decoder"], one,
                             torch.randn(one.shape, generator=g, device=device, dtype=torch.float32), lowp).cpu())
    return {"latents": lat.float().cpu(), "video": torch.cat(videos)}
