"""Model work counted from a configuration's sizes: the operations a forward
needs (for ``mfu``) and the shapes of the block linears (for the K2
roofline). Counted from the model's definition, never from what ran, so a
share reads the same work whatever implements it. A product of (M, K) by
(K, N) is 2 M K N operations; elementwise work, norms and softmax are not
counted."""

from __future__ import annotations

from typing import Dict, List, Tuple


def dit_dims(cfg: dict) -> Tuple[int, int]:
    dim = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    return dim, dim * cfg["ff_mult"]


def dit_block_linears(cfg: dict, batch: int, tokens: int, caption: int) -> List[Tuple[int, int, int, int]]:
    """(M, K, N, count) of one block's linears in one forward: attn1's q, k,
    v, out and attn2's q, out on the latent tokens, attn2's k, v on the
    caption, the feed-forward's two."""
    dim, ff = dit_dims(cfg)
    m, mc = batch * tokens, batch * caption
    return [(m, dim, dim, 6), (mc, cfg["cross_attention_dim"], dim, 2), (m, dim, ff, 1), (m, ff, dim, 1)]


def dit_forward_flops(cfg: dict, batch: int, tokens: int, caption: int) -> float:
    """One DiT forward: patchify, adaLN, caption projection, every block's
    linears, self-attention (S x S) and text cross-attention (S x caption),
    the output head."""
    dim, _ = dit_dims(cfg)
    b, s, l_ = batch, tokens, caption
    total = 2.0 * b * s * cfg["in_channels"] * dim + 2.0 * b * s * dim * cfg["out_channels"]
    total += 2.0 * b * (256 * dim + dim * dim + dim * 6 * dim)
    total += 2.0 * b * l_ * (cfg["caption_channels"] * dim + dim * dim)
    block = sum(2.0 * m * k * n * c for m, k, n, c in dit_block_linears(cfg, b, s, l_))
    block += 4.0 * b * s * s * dim + 4.0 * b * s * l_ * dim
    return total + cfg["num_layers"] * block


def conv_flops(cin: int, cout: int, taps: int, outputs: int) -> float:
    return 2.0 * cin * cout * taps * outputs


def upsampler_flops(cfg: dict, batch: int, frames: int, h: int, w: int) -> float:
    """The 2x latent upsampler on (batch, C, frames, h, w) latents."""
    u = cfg["upsampler"]
    cin, mid, n = u["in_channels"], u["mid_channels"], u["num_blocks"]
    lo, hi = batch * frames * h * w, batch * frames * 4 * h * w
    total = conv_flops(cin, mid, 27, lo) + 2 * n * conv_flops(mid, mid, 27, lo)
    total += conv_flops(mid, 4 * mid, 9, lo)
    return total + 2 * n * conv_flops(mid, mid, 27, hi) + conv_flops(mid, cin, 27, hi)


def decoder_flops(cfg: dict, frames: int, h: int, w: int) -> float:
    """One video's decode from (C, frames, h, w) latents: every 3x3x3
    convolution at its output size (a depth-to-space stage doubles H and W
    and takes the frames to 2F - 1)."""
    d = cfg["decoder"]
    chans = [d["base_channels"] // 2 ** i for i in range(d["num_upsamples"] + 1)]
    f, hh, ww = frames, h, w
    total = conv_flops(d["in_channels"], chans[0], 27, f * hh * ww)
    for g, c in enumerate(chans):
        total += 2 * d["num_layers_per_block"] * conv_flops(c, c, 27, f * hh * ww)
        if g < d["num_upsamples"]:
            total += conv_flops(c, c // 2 * 8, 27, f * hh * ww)
            f, hh, ww = 2 * f - 1, 2 * hh, 2 * ww
    return total + conv_flops(chans[-1], d["out_channels"] * d["patch_size"] ** 2, 27, f * hh * ww)


def distilled_call(cfg: dict, traffic: dict) -> Dict[str, object]:
    """One distilled call of ``num_videos`` videos: its model operations and
    its block linears' shapes with their call counts (every step's forward
    of every block)."""
    n = traffic["num_videos"]
    f = 1 + (traffic["num_frames"] - 1) // 8
    h, w = traffic["height"] // 32, traffic["width"] // 32
    cap = cfg["caption_positions"]
    s1, s2 = f * (h // 2) * (w // 2), f * h * w
    st1, st2 = traffic["stage1_steps"], traffic["stage2_steps"]
    flops = st1 * dit_forward_flops(cfg, n, s1, cap) + st2 * dit_forward_flops(cfg, n, s2, cap)
    flops += upsampler_flops(cfg, n, f, h // 2, w // 2) + n * decoder_flops(cfg, f, h, w)
    linears = [(m, k, nn, c * st1 * cfg["num_layers"]) for m, k, nn, c in dit_block_linears(cfg, n, s1, cap)]
    linears += [(m, k, nn, c * st2 * cfg["num_layers"]) for m, k, nn, c in dit_block_linears(cfg, n, s2, cap)]
    return {"flops": flops, "block_linears": linears}
