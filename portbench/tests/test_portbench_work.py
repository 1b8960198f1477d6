"""The work counts against hand counts at tiny shapes: each kernel's
roofline file, the model operations behind ``mfu``, and the readers that
turn them into shares."""

from __future__ import annotations

import pytest

from portbench import flops, readers
from portbench.roofline import PEAKS, bound_s, k1, k2, k3
from portbench.tests import tiny_cell

from importlib import util


def reader(name):
    spec = util.spec_from_file_location(name.replace(".", "_"), tiny_cell.PB / "metrics" / f"{name}.py")
    mod = util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_roofline_files_by_hand():
    # x (3, 64) bf16 by a 4-bit (8, 64) weight at group 32: 2*3*64*8 ops;
    # x 384 B, words 8*64/2 = 256 B, bf16 scales+biases 2*8*2*2 = 64 B, y 48 B
    assert k2.work(3, 64, 8, 4, 32, scale_bytes=2) == (3072.0, 384 + 256 + 64 + 48)
    assert k2.work(3, 64, 8, 4, 32)[1] == 384 + 256 + 128 + 48
    # (B, S, H, D) = (2, 4, 3, 8): 2 products of 4x4x8 a head, 2*(2*4*4*8) * 3 heads * 2 rows
    assert k1.work(2, 4, 3, 8) == (3072.0, 2 * 4 * 4 * 3 * 8 * 2)
    assert k1.work(2, 4, 3, 8, lse=True)[1] == 2 * (4 * 4 * 3 * 8 * 2 + 4 * 3 * 4)
    # five 4x4x8 products a head: 5 * 2 * 128 * 3
    assert k3.work(4, 3, 8) == (3840.0, 8 * 4 * 3 * 8 * 2 + 4 * 3 * 4)
    assert bound_s(989e12, 0) == pytest.approx(1.0)
    assert bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_dit_forward_flops_by_hand():
    cfg = tiny_cell.tiny_config()  # dim 64, ff 256, 2 blocks, in/out 16, caption 48
    b, s, c = 2, 8, 16
    d, ff = 64, 256
    head = 2 * b * s * 16 * d * 2 + 2 * b * (256 * d + d * d + 6 * d * d) + 2 * b * c * (48 * d + d * d)
    block = (2 * b * s * d * d * 6 + 2 * b * c * d * d * 2 + 2 * b * s * d * ff * 2
             + 4 * b * s * s * d + 4 * b * s * c * d)
    assert flops.dit_forward_flops(cfg, b, s, c) == head + 2 * block


def test_conv_flops_by_hand():
    cfg = tiny_cell.tiny_config()  # upsampler 16 -> 64, 1 block; decoder 64, 32, 16, 8 channels
    lo, hi = 2 * 2 * 2 * 2, 2 * 2 * 4 * 4
    ups = (2 * 16 * 64 * 27 * lo + 2 * 2 * 64 * 64 * 27 * lo + 2 * 64 * 256 * 9 * lo
           + 2 * 2 * 64 * 64 * 27 * hi + 2 * 64 * 16 * 27 * hi)
    assert flops.upsampler_flops(cfg, 2, 2, 2, 2) == ups
    # decoder on (16, 2, 4, 4): stages at 2x4x4, 3x8x8, 5x16x16, 9x32x32
    sizes, chans = [32, 192, 1280, 9216], [64, 32, 16, 8]
    dec = 2 * 16 * 64 * 27 * sizes[0]
    for g, (n, ch) in enumerate(zip(sizes, chans)):
        dec += 2 * 2 * ch * ch * 27 * n
        if g < 3:
            dec += 2 * ch * (ch // 2 * 8) * 27 * n
    dec += 2 * 8 * 48 * 27 * sizes[-1]
    assert flops.decoder_flops(cfg, 2, 4, 4) == dec


def test_distilled_call_counts():
    cfg, t = tiny_cell.tiny_config(), tiny_cell.tiny_traffic()
    work = flops.distilled_call(cfg, t)
    # 10 block linears a block a forward, (2 + 1) steps of 2 blocks
    assert sum(c for *_, c in work["block_linears"]) == 10 * 2 * 3
    assert {m for m, *_ in work["block_linears"]} == {2 * 8, 2 * 32, 2 * 16}  # stage 1, stage 2, caption rows
    assert work["flops"] == (2 * flops.dit_forward_flops(cfg, 2, 8, 16) + flops.dit_forward_flops(cfg, 2, 32, 16)
                             + flops.upsampler_flops(cfg, 2, 2, 2, 2) + 2 * flops.decoder_flops(cfg, 2, 4, 4))


def test_share_readers():
    ctx = {"unit": "video", "units": 4, "calls": 2, "wall_s": 2.0, "busy_s": 1.5,
           "work": {"flops": 989e12 / 4, "block_linears": [(3, 64, 8, 5)]},
           "cfg": {"quant": {"bits": 4, "group_size": 32, "scale_dtype": "bfloat16"}},
           "kernels": {"void quant_matmul_kernel<4>(...)": [1e-6, 20], "gemm": [0.5, 3]},
           "classes": {"gemm": 0.5, "other": 0.25}}
    assert reader("mfu.video")(ctx) == pytest.approx(50.0)  # 989e12 FLOP over 2 s at 989 TFLOP/s
    assert reader("idle_share.video")(ctx) == pytest.approx(25.0)
    assert reader("gemm_ms.video")(ctx) == pytest.approx(125.0)
    assert reader("elementwise_ms.video")(ctx) == pytest.approx(62.5)
    least = 5 * max(3072 / PEAKS["bf16_flops_per_s"], 752 / PEAKS["hbm_bytes_per_s"])
    assert reader("k2_roofline.video")(ctx) == pytest.approx(100.0 * least * 4 / 1e-6)
    assert reader("k2_roofline.video")(dict(ctx, cfg={"quant": None})) is None
    assert readers.per_unit(dict(ctx, unit="train_step"), "video", 1.0) is None
