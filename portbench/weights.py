"""Seeded weights of a configuration, drawn on the card in a few large calls.

The benchmark makes the weights and hands the same tensors to the program
(loaded into its modules with ``load_state_dict(assign=True)``) and to the
plain reference (portbench/reference/), which reads them by name. The
names and shapes are the checkpoint's, written out here from the
configuration's sizes; loading them into the program's modules with
``strict=True`` checks that the two agree.

Every dense weight is U(-1/sqrt(fan_in), 1/sqrt(fan_in)), every bias
U(-0.02, 0.02), every scale-shift table U(-0.1, 0.1), every norm weight
U(0.9, 1.1), all drawn as one flat bf16 buffer and scaled in place a tensor
at a time. A 4-bit linear's words are uniform random bytes (every 4-bit code
equally likely), its bf16 scales and biases place the dequantized weight in
about the dense weight's range: w = q s + b with s = 2 bound u / 15,
b = -bound u', u and u' in [0.8, 1.2].
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, tuple, str, int]]  # (name, shape, kind, fan_in)


def _linear(spec: Spec, name: str, fan_in: int, out: int) -> None:
    spec.append((name + ".weight", (out, fan_in), "weight", fan_in))
    spec.append((name + ".bias", (out,), "bias", 0))


def dit_spec(cfg: dict) -> Spec:
    """The VideoOnly DiT: patchify, adaLN, caption projection, blocks, head."""
    dim = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    ff = dim * cfg["ff_mult"]
    spec: Spec = []
    _linear(spec, "video.patchify_proj", cfg["in_channels"], dim)
    _linear(spec, "video.adaln_single.emb.timestep_embedder.linear1", 256, dim)
    _linear(spec, "video.adaln_single.emb.timestep_embedder.linear2", dim, dim)
    _linear(spec, "video.adaln_single.linear", dim, 6 * dim)
    _linear(spec, "video.caption_projection.linear1", cfg["caption_channels"], dim)
    _linear(spec, "video.caption_projection.linear2", dim, dim)
    spec.append(("video.scale_shift_table", (2, dim), "table", 0))
    _linear(spec, "video.proj_out", dim, cfg["out_channels"])
    for i in range(cfg["num_layers"]):
        p = f"blocks.{i}"
        for attn, ctx in (("attn1", dim), ("attn2", cfg["cross_attention_dim"])):
            _linear(spec, f"{p}.{attn}.to_q", dim, dim)
            _linear(spec, f"{p}.{attn}.to_k", ctx, dim)
            _linear(spec, f"{p}.{attn}.to_v", ctx, dim)
            _linear(spec, f"{p}.{attn}.to_out", dim, dim)
            spec.append((f"{p}.{attn}.q_norm.weight", (dim,), "norm", 0))
            spec.append((f"{p}.{attn}.k_norm.weight", (dim,), "norm", 0))
        _linear(spec, f"{p}.ff.proj_in", dim, ff)
        _linear(spec, f"{p}.ff.proj_out", ff, dim)
        spec.append((f"{p}.scale_shift_table", (6, dim), "table", 0))
    return spec


def quantized_names(cfg: dict) -> List[str]:
    """The block linears the 4-bit configuration holds packed: every linear
    of attn1, attn2 and ff in every block (the ``core`` scope)."""
    q = cfg.get("quant")
    if not q:
        return []
    if q["scope"] != "core":
        raise ValueError(f"scope {q['scope']!r}: only 'core' is written out")
    return [f"blocks.{i}.{m}" for i in range(cfg["num_layers"]) for m in (
        "attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out",
        "attn2.to_q", "attn2.to_k", "attn2.to_v", "attn2.to_out", "ff.proj_in", "ff.proj_out")]


def _conv(spec: Spec, name: str, cin: int, cout: int, k: tuple) -> None:
    fan_in = cin * math.prod(k)
    spec.append((name + ".weight", (cout, cin, *k), "weight", fan_in))
    spec.append((name + ".bias", (cout,), "bias", 0))


def _affine(spec: Spec, name: str, c: int) -> None:
    spec.append((name + ".weight", (c,), "norm", 0))
    spec.append((name + ".bias", (c,), "bias", 0))


def upsampler_spec(cfg: dict) -> Spec:
    u = cfg["upsampler"]
    cin, mid, k3 = u["in_channels"], u["mid_channels"], (3, 3, 3)
    spec: Spec = []
    _conv(spec, "initial_conv", cin, mid, k3)
    _affine(spec, "initial_norm", mid)
    for group in ("res_blocks", "post_upsample_res_blocks"):
        for i in range(u["num_blocks"]):
            for j in (1, 2):
                _conv(spec, f"{group}.{i}.conv{j}", mid, mid, k3)
                _affine(spec, f"{group}.{i}.norm{j}", mid)
    _conv(spec, "upsampler.conv", mid, 4 * mid, (3, 3))
    _conv(spec, "final_conv", mid, cin, k3)
    return spec


def decoder_spec(cfg: dict) -> Spec:
    d = cfg["decoder"]
    chans = [d["base_channels"] // 2 ** i for i in range(d["num_upsamples"] + 1)]
    k3 = (3, 3, 3)
    spec: Spec = []
    _conv(spec, "conv_in", d["in_channels"], chans[0], k3)
    spec.append(("latents_mean", (d["in_channels"],), "stat_mean", 0))
    spec.append(("latents_std", (d["in_channels"],), "stat_std", 0))
    for g, c in enumerate(chans):
        p = f"up_blocks.{2 * g}"
        for j in range(d["num_layers_per_block"]):
            _conv(spec, f"{p}.res_blocks.{j}.conv1", c, c, k3)
            _conv(spec, f"{p}.res_blocks.{j}.conv2", c, c, k3)
            spec.append((f"{p}.res_blocks.{j}.scale_shift_table", (4, c), "table", 0))
        _linear(spec, f"{p}.time_embedder.linear_1", 256, 4 * c)
        _linear(spec, f"{p}.time_embedder.linear_2", 4 * c, 4 * c)
        if g < d["num_upsamples"]:
            _conv(spec, f"up_blocks.{2 * g + 1}.conv", c, c // 2 * 8, k3)
    _conv(spec, "conv_out", chans[-1], d["out_channels"] * d["patch_size"] ** 2, k3)
    _linear(spec, "last_time_embedder.linear_1", 256, 2 * chans[-1])
    _linear(spec, "last_time_embedder.linear_2", 2 * chans[-1], 2 * chans[-1])
    spec.append(("last_scale_shift_table", (2, chans[-1]), "table", 0))
    return spec


def encoder_spec(cfg: dict) -> Spec:
    """The VAE encoder: patchify, conv_in, the blocks (res_x groups of
    resnet blocks, space-to-depth downsamples), conv_out to C + 1."""
    e = cfg["encoder"]
    k3 = (3, 3, 3)
    feat = e["out_channels"]
    spec: Spec = []
    _conv(spec, "conv_in", e["in_channels"] * e["patch_size"] ** 2, feat, k3)
    spec.append(("per_channel_statistics.mean", (feat,), "stat_mean", 0))
    spec.append(("per_channel_statistics.std", (feat,), "stat_std", 0))
    strides = {"compress_all_res": 8, "compress_space_res": 4, "compress_time_res": 2}
    for i, (name, bcfg) in enumerate(e["blocks"]):
        if name == "res_x":
            for j in range(bcfg["num_layers"]):
                _conv(spec, f"down_blocks.{i}.res_blocks.{j}.conv1", feat, feat, k3)
                _conv(spec, f"down_blocks.{i}.res_blocks.{j}.conv2", feat, feat, k3)
        else:
            out = feat * bcfg.get("multiplier", 2)
            _conv(spec, f"down_blocks.{i}.conv", feat, out // strides[name], k3)
            feat = out
    _conv(spec, "conv_out", feat, e["out_channels"] + 1, k3)
    return spec


SPECS = {"upsampler": upsampler_spec, "decoder": decoder_spec, "encoder": encoder_spec}
BOUNDS = {"bias": (-0.02, 0.02), "table": (-0.1, 0.1), "norm": (0.9, 1.1)}


def _draw(spec: Spec, g: torch.Generator, device, dtype, packed: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """One flat U(-1, 1) buffer for the spec's floating tensors (a packed
    linear's weight left out), scaled in place a tensor at a time; one flat
    buffer of random bytes for the packed words and one of U(0.8, 1.2) for
    their scales and biases."""
    out: Dict[str, torch.Tensor] = {}
    dense = [(n, s, k, f) for n, s, k, f in spec if not (k == "weight" and n[:-len(".weight")] in packed)
             and not k.startswith("stat")]
    flat = torch.empty(sum(math.prod(s) for _, s, _, _ in dense), dtype=dtype, device=device)
    flat.uniform_(-1.0, 1.0, generator=g)
    at = 0
    with torch.no_grad():
        for name, shape, kind, fan_in in dense:
            t = flat[at:at + math.prod(shape)].view(shape)
            at += math.prod(shape)
            if kind == "weight":
                t.mul_(fan_in ** -0.5)
            else:
                lo, hi = BOUNDS[kind]
                t.mul_((hi - lo) / 2).add_((hi + lo) / 2)
            out[name] = t
        for name, shape, kind, _ in spec:
            if kind == "stat_mean":
                out[name] = torch.empty(shape, device=device).uniform_(-0.1, 0.1, generator=g)
            elif kind == "stat_std":
                out[name] = torch.empty(shape, device=device).uniform_(0.7, 1.3, generator=g)
        if packed:
            words = sum(out_dim * in_dim * bits // 32 for out_dim, in_dim, bits, _ in packed.values())
            groups = sum(out_dim * in_dim // gs for out_dim, in_dim, _, gs in packed.values())
            raw = torch.empty(4 * words, dtype=torch.uint8, device=device).random_(0, 256, generator=g)
            raw = raw.view(torch.int32)
            aff = torch.empty(2 * groups, dtype=dtype, device=device).uniform_(0.8, 1.2, generator=g)
            wat = gat = 0
            for name, (out_dim, in_dim, bits, gs) in packed.items():
                n_w, n_g = out_dim * in_dim * bits // 32, out_dim * in_dim // gs
                bound = in_dim ** -0.5
                out[name + ".quant_weight"] = raw[wat:wat + n_w].view(out_dim, -1)
                out[name + ".scales"] = aff[gat:gat + n_g].view(out_dim, -1).mul_(2 * bound / (2 ** bits - 1))
                out[name + ".biases"] = aff[groups + gat:groups + gat + n_g].view(out_dim, -1).mul_(-bound)
                wat, gat = wat + n_w, gat + n_g
    return out


def draw_weights(cfg: dict, seed: int, device, parts=("upsampler", "decoder")) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"dit", *parts}: name -> tensor, on ``device``, from ``seed`` alone
    (the DiT first, then each part in the order given)."""
    dtype = getattr(torch, cfg["dtype"])
    g = torch.Generator(device=device).manual_seed(int(seed))
    q = cfg.get("quant")
    shapes = {n: s for n, s, _, _ in dit_spec(cfg)}
    packed = {name: (*shapes[name + ".weight"], q["bits"], q["group_size"]) for name in quantized_names(cfg)}
    out = {"dit": _draw(dit_spec(cfg), g, device, dtype, packed)}
    for part in parts:
        out[part] = _draw(SPECS[part](cfg), g, device, dtype, {})
    return out


def draw_context(cfg: dict, seed: int, device) -> torch.Tensor:
    """A seeded prompt embedding (1, caption positions, caption channels) in
    the configuration's dtype: what the text encoder hands the DiT."""
    g = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    shape = (1, cfg["caption_positions"], cfg["caption_channels"])
    return torch.randn(shape, generator=g, device=device).to(getattr(torch, cfg["dtype"]))
