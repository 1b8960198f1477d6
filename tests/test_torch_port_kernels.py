"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs where JAX is not installed, without the repo's
conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_port_kernels.py

Bars, flash attention: max |d o| <= 2e-2 (the bf16 output rounds to one ulp,
1.6e-2 at |o| ~ 2-4) and max |d lse| <= 1e-3 (fp32 sums in another order).
Flash backward (K3): per gradient, relative L2 <= 5e-3 and max |d| <= 2e-2 *
max |ref| against the plain fp32 backward on the same bf16 inputs: the kernel
rounds p and dS to bf16 before their products (as the Pallas kernels do) and
rounds dQ, dK and dV to bf16, each ~2^-9 relative (both bars have a floor of
1e-4 an element, for dQ at S = 1, which is zero in exact arithmetic); its
gradients are bitwise repeatable (no atomics).
Cross-attention (K4) and flash attention with split RoPE (K5): K1's bars
against their plain versions (K5's lse too). K5's rotation pass computes the
plain rotation operation for operation, so its rotated q and k equal
rotate_split's bit for bit, and K5 then runs K1's kernel on them: its o and
lse equal K1's on the plainly rotated q and k bit for bit, and its own on
those inputs under identity tables (cos = 1, sin = 0). Its autograd
gradients (K3 on the rotated inputs) meet K3's bars against plain autograd
through the plain version.
Dequantizing matmul: max |d y| <= 1e-2 * max |y| and relative L2 <= 1e-3;
both sides multiply the same bf16 weights, only the summation order and the
bf16 rounding of y differ. The L2 bar separates a kernel that rounds fp32
scales and biases to bf16 before the affine (the Pallas kernel's way): that
moves y by more (test_quant_kernel_bar_rejects_bf16_rounded_scales).
Int8 attention (K6): max |d o| <= 2e-2 and relative L2 <= 1e-3 against its
plain version on the same inputs (the same integer products; only p_q codes
where an exp ulp crosses a half differ, and at most 1e-4 of them); against
K1 on the same bf16 inputs relative L2 < 5e-2, the quantization error by
design (the JAX test's bar). Two calls give the same bits. Its CUDA
prologue divides and rounds as the plain prologue does, so its operands
equal int8_attention_operands' bit for bit.
The int8 products of W8A8 (torch._int_mm) are exact, so the card's int32
equals the CPU's. quantize_affine divides as JAX's quantize_affine does, so
its scales, biases and words on the card equal the CPU's.
The LoRA merge on the card (lora.merge_lora_into_params: fp32 B A in full
fp32, even with TF32 switched on, added to W in fp32) against the CPU's:
fp32 weights within one ulp, bf16 weights with at most 1e-4 of the elements
one bf16 ulp apart (cuBLAS and the CPU sum the rank products in their own
orders).
"""

import copy
import threading

import pytest
import torch

from mlx_video_tpu_torch.models.ltx import rope
from mlx_video_tpu_torch.ops import cross_attention as ca
from mlx_video_tpu_torch.ops import flash_attention as fa
from mlx_video_tpu_torch.ops import int8 as i8
from mlx_video_tpu_torch.ops import quant_matmul as qmm
from mlx_video_tpu_torch.ops.quant import quantize_affine


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _bf16(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)


def _check(out, ref):
    (o, lse), (ro, rlse) = out, ref
    assert o.shape == ro.shape and o.dtype == torch.bfloat16
    assert (o.float() - ro.float()).abs().max().item() <= 2e-2
    assert lse.shape == rlse.shape and (lse - rlse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b, s, h, d", [
    (1, 320, 32, 128), (1, 1280, 8, 128), (2, 1000, 4, 128), (1, 1, 2, 128),
    (1, 63, 3, 64), (1, 65, 3, 64), (2, 700, 4, 64),
    # S on each side of the 128-key tile and of two 128-row query blocks
    (1, 127, 4, 128), (1, 128, 4, 128), (1, 129, 4, 128), (2, 255, 3, 128), (2, 257, 3, 128),
    (1, 127, 3, 64), (2, 129, 3, 64), (2, 257, 3, 64),
    # B * H = 320 and 512: several waves of blocks over the 132 SMs
    (4, 257, 80, 128), (8, 129, 64, 64),
    # the audio self-attention of the AV paths (32 x 64 heads): 34 tokens
    # (512x512x33), 34 at B = 2 (the AudioOnly DiT under audio CFG), 68 at
    # B = 2 (768x768x65, batched CFG), and one
    (1, 34, 32, 64), (2, 34, 32, 64), (2, 68, 32, 64), (2, 1, 32, 64),
    # the AV LoRA step's audio self-attention: 67 audio latent frames of a
    # 65-frame clip at 24 fps (less than one 128-key tile, ragged)
    (1, 67, 32, 64),
])
def test_kernel_matches_plain(gen, b, s, h, d):
    q, k, v = (_bf16(gen, b, s, h, d) for _ in range(3))
    before = fa.launch_count
    out = fa.flash_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert fa.launch_count == before + 1
    _check(out, fa.flash_attention_reference(q, k, v, d**-0.5, return_lse=True))


@pytest.mark.cuda
@pytest.mark.parametrize("s, h, d", [(300, 4, 128), (333, 5, 64)])
def test_kernel_reads_strided_operands_in_place(gen, s, h, d):
    """q, k, v as views of one fused (B, S, 3, H, D) projection."""
    qkv = _bf16(gen, 2, s, 3, h, d)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v, scale=0.05, return_lse=True)
    _check(out, fa.flash_attention_reference(q, k, v, 0.05, return_lse=True))


@pytest.mark.cuda
def test_kernel_is_exact_past_the_tpu_clamp(gen):
    """Scaled logits of ~100: the Pallas single-pass body would saturate."""
    q, k = (_bf16(gen, 1, 512, 2, 128) * 10 for _ in range(2))
    v = _bf16(gen, 1, 512, 2, 128)
    _check(fa.flash_attention(q, k, v, return_lse=True),
           fa.flash_attention_reference(q, k, v, 128**-0.5, return_lse=True))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(gen):
    q = torch.zeros(1, 64, 2, 128, device="cuda")
    before = fa.launch_count
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q, q, q)
    q = q.to(torch.bfloat16)[..., :96]
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    assert fa.launch_count == before


def _check_grads(got, ref):
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.shape == r.shape and g.dtype == torch.bfloat16, name
        d = g.float() - r.float()
        # plus 1e-4 an element for a gradient that is zero in exact arithmetic (dQ at S = 1)
        assert d.norm().item() <= 5e-3 * r.float().norm().item() + 1e-4 * d.numel() ** 0.5, name
        assert d.abs().max().item() <= 2e-2 * r.float().abs().max().item() + 1e-4, name


def _bwd_inputs(gen, b, s, h, d):
    q, k, v, do = (_bf16(gen, b, s, h, d) for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("b, s, h, d", [
    (1, 320, 32, 128), (1, 1280, 4, 128), (2, 1000, 4, 128), (1, 1, 2, 128),
    (1, 63, 3, 64), (1, 65, 3, 64), (2, 700, 4, 64), (1, 3456, 2, 128),
    # S on each side of the 64-row tile and of the 128-row block
    (1, 64, 4, 128), (1, 127, 4, 128), (1, 128, 4, 128), (1, 129, 4, 128), (2, 255, 3, 128),
    # the AV LoRA step's audio self-attention (67 tokens, under one dkv block)
    (1, 67, 32, 64),
])
def test_bwd_kernel_matches_plain(gen, b, s, h, d):
    q, k, v, o, lse, do = _bwd_inputs(gen, b, s, h, d)
    before = fa.bwd_launch_count
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, d**-0.5)
    torch.cuda.synchronize()
    assert fa.bwd_launch_count == before + 1
    _check_grads(got, fa.flash_attention_bwd_reference(q, k, v, o, lse, do, d**-0.5))


@pytest.mark.cuda
def test_bwd_kernel_is_bitwise_repeatable(gen):
    args = _bwd_inputs(gen, 1, 1000, 4, 128)
    first = fa.flash_attention_bwd(*args, 128**-0.5)
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(first, fa.flash_attention_bwd(*args, 128**-0.5)))


@pytest.mark.cuda
def test_bwd_kernel_reads_strided_operands(gen):
    """q, k, v as views of one fused projection; dO as a transposed view
    (copied contiguous by the wrapper)."""
    qkv = _bf16(gen, 2, 300, 3, 4, 128)
    q, k, v = qkv.unbind(2)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    do = _bf16(gen, 2, 4, 300, 128).transpose(1, 2)
    assert not do.is_contiguous()
    _check_grads(fa.flash_attention_bwd(q, k, v, o, lse, do, 128**-0.5),
                 fa.flash_attention_bwd_reference(q, k, v, o, lse, do, 128**-0.5))


@pytest.mark.cuda
def test_flash_attention_is_differentiable_on_the_card(gen):
    """Autograd through flash_attention runs K1 with lse, then K3."""
    q, k, v = (_bf16(gen, 1, 500, 4, 128).requires_grad_() for _ in range(3))
    do = _bf16(gen, 1, 500, 4, 128)
    k1, k3 = fa.launch_count, fa.bwd_launch_count
    out = fa.flash_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (fa.launch_count, fa.bwd_launch_count) == (k1 + 1, k3 + 1)
    o, lse = fa.flash_attention_reference(q.detach(), k.detach(), v.detach(), 128**-0.5, return_lse=True)
    _check_grads(got, fa.flash_attention_bwd_reference(q, k, v, o, lse, do, 128**-0.5))


@pytest.mark.cuda
def test_kernels_launch_from_a_fresh_thread(gen):
    """K1, K3 and K6 encode their tensor maps through the driver, which needs
    a current context: a thread whose first CUDA call is the kernel's (an
    autograd worker) must get the same results as the main thread."""
    q, k, v, o, lse, do = _bwd_inputs(gen, 1, 300, 4, 128)

    def run():
        return (*fa.flash_attention(q, k, v, return_lse=True), *fa.flash_attention_bwd(q, k, v, o, lse, do, 128**-0.5),
                *fa.flash_attention_int8(q, k, v, return_codes=True))

    want, got = run(), []
    worker = threading.Thread(target=lambda: got.append(run()))
    worker.start()
    worker.join()
    assert got, "the kernels raised in the worker thread"
    for a, b in zip(got[0], want):
        assert torch.equal(a, b)


def _masked_bias(gen, b, skv, real):
    """(B, Skv) caption-mask bias rows, (mask - 1) * 1e9 as the DiT makes them
    in bf16; ``real[i]`` keys of row i are unmasked."""
    mask = torch.zeros(b, skv, device="cuda")
    for i, n in enumerate(real):
        mask[i, :n] = 1.0
    return ((mask.to(torch.bfloat16) - 1.0) * 1e9).float()


@pytest.mark.cuda
@pytest.mark.parametrize("b, sq, skv, h, d, real", [
    (2, 5184, 128, 4, 128, None), (1, 3456, 1024, 2, 128, (128,)), (2, 1000, 77, 4, 128, None),
    (2, 700, 128, 4, 128, (128, 0)), (2, 640, 128, 3, 128, (40, 100)), (1, 65, 1, 2, 64, None),
    (2, 300, 200, 4, 64, (150, 7)),
    # Sq below one 128-row query tile, and one past a whole number of them
    (1, 100, 128, 4, 128, (100,)), (2, 1281, 127, 4, 128, None), (1, 127, 128, 8, 64, None),
    # Skv on each side of the resident caption tile, one key, and all masked
    # over streamed tiles
    (2, 129, 1, 3, 128, None), (1, 257, 129, 4, 128, (129,)), (2, 300, 1024, 2, 128, (1024, 0)),
    # D = 64 with a resident tile: runs of query tiles that cross heads
    (2, 2000, 77, 16, 64, (77, 30)),
    # the AV dev path's (32 x 64 heads, batched CFG): audio text attention,
    # audio-to-video (resident, 68 audio keys) and video-to-audio (streamed,
    # 68 query rows over 5184 video keys)
    (2, 68, 128, 32, 64, None), (2, 5184, 68, 32, 64, None), (2, 68, 5184, 32, 64, None),
])
def test_cross_kernel_matches_plain(gen, b, sq, skv, h, d, real):
    """No bias, the trainer's 128-real mask over 1024 keys, a ragged Skv, a
    row whose keys are all masked, two rows with different masks, and the
    edges of the resident and streamed designs."""
    q = _bf16(gen, b, sq, h, d)
    k, v = (_bf16(gen, b, skv, h, d) for _ in range(2))
    bias = None if real is None else _masked_bias(gen, b, skv, real)
    before = ca.launch_count
    out = ca.flash_cross_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    assert ca.launch_count == before + 1
    ref = ca.flash_cross_attention_reference(q, k, v, bias=bias)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    if real is not None and 0 in real:  # uniform over every key: the mean of v
        row = real.index(0)
        mean = v[row].float().mean(0)
        assert (out[row].float() - mean[None]).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_cross_kernel_reads_strided_operands_and_broadcast_bias(gen):
    """q a view of a fused projection, k and v views of one (B, Skv, 2, H, D)
    tensor, one bias row for both batch rows."""
    q = _bf16(gen, 2, 300, 3, 4, 128).unbind(2)[1]
    k, v = _bf16(gen, 2, 50, 2, 4, 128).unbind(2)
    bias = _masked_bias(gen, 1, 50, (30,))
    out = ca.flash_cross_attention(q, k, v, bias=bias, scale=0.07)
    ref = ca.flash_cross_attention_reference(q, k, v, bias=bias, scale=0.07)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_cross_kernel_rejects_what_it_does_not_take(gen):
    q, k = torch.zeros(1, 64, 2, 128, device="cuda"), torch.zeros(1, 8, 2, 128, device="cuda")
    before = ca.launch_count
    with pytest.raises(ValueError, match="bfloat16"):
        ca.flash_cross_attention(q, k, k)
    q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        ca.flash_cross_attention(q[..., :96], k[..., :96], k[..., :96])
    with pytest.raises(ValueError, match="bias"):
        ca.flash_cross_attention(q, k, k, bias=torch.zeros(1, 9, device="cuda"))
    assert ca.launch_count == before


@pytest.mark.cuda
def test_cross_kernel_is_differentiable(gen):
    q = _bf16(gen, 2, 200, 2, 128).requires_grad_()
    k, v = (_bf16(gen, 2, 40, 2, 128).requires_grad_() for _ in range(2))
    bias, do = _masked_bias(gen, 2, 40, (40, 20)), _bf16(gen, 2, 200, 2, 128)
    before = ca.launch_count
    got = torch.autograd.grad(ca.flash_cross_attention(q, k, v, bias=bias), (q, k, v), do)
    assert ca.launch_count == before + 1
    ref = torch.autograd.grad(ca.flash_cross_attention_reference(q, k, v, bias=bias), (q, k, v), do)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)  # the backward is the plain version's


def _tables(b, s, h, d):
    """Split-RoPE (cos, sin) as models/ltx/rope.py makes them: fp32, the
    (B, H, S, D/2) transposed view of a (B, S, H * D/2) array."""
    grid = torch.stack(torch.meshgrid(torch.arange(4.0), torch.arange(16.0), torch.arange(s / 64 + 1),
                                      indexing="ij"), 0).reshape(1, 3, -1)[:, :, :s]
    pos = torch.stack([grid, grid + 1], -1).expand(b, -1, -1, -1).cuda()
    return rope.precompute_freqs_cis(pos, dim=h * d, num_attention_heads=h, rope_type=rope.LTXRopeType.SPLIT,
                                     max_pos=[20, 2048, 2048], use_middle_indices_grid=True)


def _audio_tables(b, t, h, d):
    """Split-RoPE tables of the audio stream: its 1-D time grid."""
    from mlx_video_tpu_torch.pipelines.positions import create_audio_position_grid

    pos = torch.from_numpy(create_audio_position_grid(b, t)).cuda()
    return rope.precompute_freqs_cis(pos, dim=h * d, num_attention_heads=h, rope_type=rope.LTXRopeType.SPLIT,
                                     max_pos=[20], use_middle_indices_grid=True)


@pytest.mark.cuda
@pytest.mark.parametrize("b, s, h, d", [(2, 1280, 4, 128), (1, 1000, 4, 128), (1, 1, 2, 128), (2, 700, 4, 64),
                                        (2, 68, 32, 64)])
def test_rope_kernel_matches_plain_and_k1_on_rotated_inputs(gen, b, s, h, d):
    """The last case is the AV dev path's audio self-attention, on the
    audio stream's tables."""
    q, k, v = (_bf16(gen, b, s, h, d) for _ in range(3))
    cos, sin = (_audio_tables if s == 68 else _tables)(b, s, h, d)
    assert s == 1 or not cos.is_contiguous()
    before, before_rope = fa.launch_count, fa.rope_launch_count
    out = fa.flash_attention_split_rope(q, k, v, cos, sin, return_lse=True)
    torch.cuda.synchronize()
    assert (fa.launch_count, fa.rope_launch_count) == (before, before_rope + 1)
    _check(out, fa.flash_attention_split_rope_reference(q, k, v, cos, sin, d**-0.5, return_lse=True))
    qr, kr = fa.rotate_split(q, cos, sin), fa.rotate_split(k, cos, sin)
    flat = q.reshape(b, s, h * d)
    assert torch.equal(qr.reshape(b, s, h * d), rope.apply_split_rotary_emb(flat, cos, sin))
    # the rotation pass is the plain one, bit for bit: K5 on the plainly
    # rotated q, k under identity tables (x * 1 - 0 * y = x) gives the same bits
    o_id, lse_id = fa.flash_attention_split_rope(qr, kr, v, torch.ones_like(cos), torch.zeros_like(sin),
                                                 return_lse=True)
    assert torch.equal(out[0], o_id) and torch.equal(out[1], lse_id)
    # and K5 is K1 on those rotated inputs, bit for bit
    before = fa.launch_count
    o1, lse1 = fa.flash_attention(qr, kr, v, return_lse=True)
    assert torch.equal(out[0], o1) and torch.equal(out[1], lse1)
    assert fa.launch_count == before + 1 and fa.rope_launch_count == before_rope + 2


@pytest.mark.cuda
@pytest.mark.parametrize("b, s, h, d, concat", [
    (1, 1000, 4, 128, False), (2, 1280, 4, 128, True), (1, 1, 2, 128, False), (2, 1, 2, 64, True),
    (1, 700, 4, 64, False), (2, 333, 3, 64, True),
])
def test_rope_rotation_pass_equals_rotate_split(gen, b, s, h, d, concat):
    """K5's rotation pass against the plain rotation, bit for bit: tables as
    the transposed view the DiT makes, or two of them concatenated to B = 2
    as batched CFG does; q and k read in place through a fused projection's
    strides."""
    if concat:
        cos, sin = (torch.cat([t, t]) for t in _tables(1, s, h, d))
    else:
        cos, sin = _tables(b, s, h, d)
    q, k = _bf16(gen, b, s, 3, h, d).unbind(2)[:2]
    counts = fa.launch_count, fa.rope_launch_count
    qr, kr = fa.rope_rotate(q, k, cos, sin)
    torch.cuda.synchronize()
    assert (fa.launch_count, fa.rope_launch_count) == counts
    assert qr.is_contiguous() and kr.is_contiguous()
    assert torch.equal(qr, fa.rotate_split(q, cos, sin)) and torch.equal(kr, fa.rotate_split(k, cos, sin))


@pytest.mark.cuda
def test_rope_kernel_is_differentiable_through_k3(gen):
    q, k, v = (_bf16(gen, 1, 600, 4, 128).requires_grad_() for _ in range(3))
    cos, sin = _tables(1, 600, 4, 128)
    do = _bf16(gen, 1, 600, 4, 128)
    k3, k5 = fa.bwd_launch_count, fa.rope_launch_count
    got = torch.autograd.grad(fa.flash_attention_split_rope(q, k, v, cos, sin), (q, k, v), do)
    assert (fa.bwd_launch_count, fa.rope_launch_count) == (k3 + 1, k5 + 1)
    # plain autograd on the same bf16 leaves: fp32 arithmetic, bf16 roundings where the kernels round
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(fa.flash_attention_split_rope_reference(*leaves, cos, sin, 128**-0.5), leaves, do)
    _check_grads(got, ref)


@pytest.mark.cuda
def test_rope_kernel_rejects_what_it_does_not_take(gen):
    q = _bf16(gen, 1, 64, 2, 128)
    cos, sin = _tables(1, 64, 2, 128)
    before = fa.rope_launch_count
    with pytest.raises(ValueError, match="fp32"):
        fa.flash_attention_split_rope(q, q, q, cos.bfloat16(), sin.bfloat16())
    with pytest.raises(ValueError, match="fp32 table"):
        fa.flash_attention_split_rope(q, q, q, cos[:, :1], sin[:, :1])
    with pytest.raises(ValueError, match="gradient"):
        fa.flash_attention_split_rope(q, q, q, cos.clone().requires_grad_(), sin)
    assert fa.rope_launch_count == before


def _quantized(gen, m, k, n, bits, group, scale_dtype=torch.float32):
    x = _bf16(gen, m, k)
    w = torch.randn(n, k, generator=gen, device="cuda") * k**-0.5
    packed, scales, biases = quantize_affine(w, group, bits)
    return x, packed, scales.to(scale_dtype), biases.to(scale_dtype)


def _check_qmm(y, ref):
    assert y.shape == ref.shape and y.dtype == ref.dtype == torch.bfloat16
    d = (y.float() - ref.float())
    assert d.abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    assert (d.norm() / ref.float().norm()).item() <= 1e-3


F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n, bits, group, scale_dtype", [
    (320, 4096, 4096, 4, 64, F32), (128, 4096, 4096, 4, 64, F32), (300, 4096, 16384, 4, 64, F32),
    (1280, 16384, 4096, 4, 64, F32), (77, 512, 200, 8, 128, F32), (1, 256, 64, 2, 32, F32),
    (5, 96, 130, 4, 32, F32), (5, 96, 130, 4, 16, F32), (33, 1024, 96, 8, 256, F32),
    # where an x tile or a split of K ends: M = 1, 65, 257, 321
    (1, 4096, 4096, 4, 64, F32), (65, 1024, 256, 4, 64, F32), (257, 4096, 1024, 4, 64, F32),
    (321, 4096, 4096, 4, 64, F32),
    # ragged weight tiles: N = 130 and 200
    (64, 512, 130, 4, 64, F32), (300, 1024, 200, 4, 32, F32),
    # K at the edge of a stage (64 values) and of a split: one stage, a stage
    # and a bit, 65 stages over a cluster of 4, 3 stages
    (128, 64, 256, 8, 64, F32), (16, 72, 128, 4, 8, F32), (128, 4160, 512, 4, 64, F32),
    (128, 192, 384, 4, 64, F32),
    # every bits x group the wrapper takes, at K = 96 (bits 2: 24-byte rows of words)
    (5, 96, 130, 2, 16, F32), (5, 96, 130, 2, 48, F32), (70, 96, 64, 2, 96, F32),
    (40, 96, 100, 4, 8, F32), (40, 96, 100, 4, 24, F32), (40, 192, 100, 4, 96, F32),
    (33, 96, 70, 8, 4, F32), (33, 96, 70, 8, 12, F32),
    # bf16 and fp16 scales at path shapes, and with an odd group count a row
    (320, 4096, 4096, 4, 64, BF16), (128, 4096, 4096, 4, 64, F16), (5, 96, 130, 4, 32, F16),
    (33, 96, 70, 8, 12, BF16),
    # the AV paths': cross-modal projections of 320 video rows, 68 audio rows
    # (B = 2, audio CFG) through the FFN, 256 audio caption rows
    (320, 4096, 2048, 4, 64, F32), (320, 2048, 4096, 4, 64, F32), (68, 2048, 8192, 4, 64, F32),
    (68, 8192, 2048, 4, 64, F32), (256, 2048, 2048, 4, 64, F32),
    # the AV LoRA step's: 67 audio rows, the cross-modal projections of the
    # 3456 video rows, 1024 audio caption rows
    (67, 2048, 2048, 4, 64, F32), (67, 2048, 8192, 4, 64, F32), (67, 8192, 2048, 4, 64, F32),
    (3456, 4096, 2048, 4, 64, F32), (3456, 2048, 4096, 4, 64, F32), (1024, 2048, 2048, 4, 64, F32),
])
def test_quant_kernel_matches_plain(gen, m, k, n, bits, group, scale_dtype):
    x, packed, scales, biases = _quantized(gen, m, k, n, bits, group, scale_dtype)
    before = qmm.launch_count
    y = qmm.quant_matmul(x, packed, scales, biases, bits, group)
    torch.cuda.synchronize()
    assert qmm.launch_count == before + 1
    _check_qmm(y, qmm.quant_matmul_reference(x, packed, scales, biases, bits, group))


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n", [(128, 4096, 4096), (1280, 4096, 4096), (321, 4096, 1024)])
def test_quant_kernel_is_bitwise_repeatable(gen, m, k, n):
    """Splits of K add their fp32 tiles in a fixed order: no atomics."""
    x, packed, scales, biases = _quantized(gen, m, k, n, 4, 64)
    y1 = qmm.quant_matmul(x, packed, scales, biases, 4, 64)
    y2 = qmm.quant_matmul(x, packed, scales, biases, 4, 64)
    assert torch.equal(y1, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float16])
def test_quant_kernel_reads_half_scales(gen, scale_dtype):
    """MLX snapshots store scales and biases in bf16 or fp16."""
    x, packed, scales, biases = _quantized(gen, 64, 1024, 256, 4, 64, scale_dtype)
    y = qmm.quant_matmul(x.reshape(2, 32, 1024), packed, scales, biases, 4, 64)
    assert y.shape == (2, 32, 256)
    ref = qmm.quant_matmul_reference(x, packed, scales, biases, 4, 64)
    _check_qmm(y.reshape(64, 256), ref)
    # views that start between two 4-byte words
    odd_s = torch.empty(scales.numel() + 1, dtype=scale_dtype, device="cuda")[1:].view_as(scales).copy_(scales)
    odd_b = torch.empty(biases.numel() + 1, dtype=scale_dtype, device="cuda")[1:].view_as(biases).copy_(biases)
    assert odd_s.data_ptr() % 4 == 2
    assert torch.equal(qmm.quant_matmul(x, packed, odd_s, odd_b, 4, 64), y.reshape(64, 256))


@pytest.mark.cuda
def test_quant_kernel_bar_rejects_bf16_rounded_scales(gen):
    """The control: the plain version on bf16-rounded scales and biases
    fails the bar that the kernel passes."""
    x, packed, scales, biases = _quantized(gen, 320, 4096, 1024, 4, 64)
    ref = qmm.quant_matmul_reference(x, packed, scales, biases, 4, 64)
    _check_qmm(qmm.quant_matmul(x, packed, scales, biases, 4, 64), ref)
    with pytest.raises(AssertionError):
        _check_qmm(qmm.quant_matmul_reference(x, packed, scales.bfloat16(), biases.bfloat16(), 4, 64), ref)


@pytest.mark.cuda
def test_quant_kernel_rejects_what_it_does_not_take(gen):
    x, packed, scales, biases = _quantized(gen, 8, 256, 64, 4, 64)
    before = qmm.launch_count
    with pytest.raises(ValueError, match="bfloat16"):
        qmm.quant_matmul(x.float(), packed, scales, biases, 4, 64)
    with pytest.raises(ValueError, match="bits"):
        qmm.quant_matmul(x, packed, scales, biases, 3, 64)
    with pytest.raises(ValueError):
        qmm.quant_matmul(x[:, :200], packed, scales, biases, 4, 64)
    with pytest.raises(ValueError, match="int32"):
        qmm.quant_matmul(x, packed.float(), scales, biases, 4, 64)
    with pytest.raises(ValueError, match="whole"):
        qmm.quant_matmul(x, packed, scales, biases, 4, 4)
    assert qmm.launch_count == before


def _check_int8(out, codes, ref, ref_codes, k1):
    d = out.float() - ref.float()
    assert out.shape == ref.shape and out.dtype == ref.dtype and torch.isfinite(out).all()
    assert d.abs().max().item() <= 2e-2
    assert d.norm().item() <= 1e-3 * ref.float().norm().item()
    assert (codes != ref_codes).sum().item() <= 1e-4 * codes.numel()
    assert (out.float() - k1.float()).norm().item() < 5e-2 * k1.float().norm().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b, s, h, d", [
    (1, 320, 8, 128), (1, 1280, 4, 128), (2, 1000, 4, 128), (1, 1, 2, 128), (1, 63, 3, 64), (2, 700, 4, 64),
])
def test_int8_kernel_matches_plain(gen, b, s, h, d):
    q, k, v = (_bf16(gen, b, s, h, d) for _ in range(3))
    before = fa.int8_launch_count
    out, codes = fa.flash_attention_int8(q, k, v, return_codes=True)
    torch.cuda.synchronize()
    assert fa.int8_launch_count == before + 1
    ref, ref_codes = fa.flash_attention_int8_reference(q, k, v, return_codes=True)
    _check_int8(out, codes, ref, ref_codes, fa.flash_attention(q, k, v))


@pytest.mark.cuda
def test_int8_kernel_takes_fp32_and_non_uniform_rows(gen):
    """fp32 in and out; rows with one dominant key next to flat rows, so p_q
    holds every code from 0 to 127 and the P V fragments are not uniform."""
    q, k, v = (torch.randn(1, 200, 2, 128, generator=gen, device="cuda") for _ in range(3))
    q[:, ::3] *= 8.0
    out, codes = fa.flash_attention_int8(q, k, v, return_codes=True)
    ref, ref_codes = fa.flash_attention_int8_reference(q, k, v, return_codes=True)
    assert out.dtype == torch.float32 and len(torch.unique(ref_codes)) > 100
    _check_int8(out, codes, ref, ref_codes, fa.flash_attention_reference(q, k, v, 128**-0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("b, s, h, d", [
    # S on each side of the 128-key tile and of two 128-row query blocks
    (1, 127, 4, 128), (1, 128, 4, 128), (1, 129, 4, 128), (2, 255, 3, 128), (2, 257, 3, 128),
    (1, 127, 3, 64), (2, 129, 3, 64), (2, 257, 3, 64),
    # B * H = 320 and 512: several waves of blocks over the 132 SMs
    (4, 257, 80, 128), (8, 129, 64, 64),
])
def test_int8_kernel_at_tile_edges(gen, b, s, h, d):
    q, k, v = (_bf16(gen, b, s, h, d) for _ in range(3))
    out, codes = fa.flash_attention_int8(q, k, v, return_codes=True)
    ref, ref_codes = fa.flash_attention_int8_reference(q, k, v, return_codes=True)
    _check_int8(out, codes, ref, ref_codes, fa.flash_attention(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [None, -0.1])
def test_int8_kernel_takes_all_negative_rows(gen, scale):
    """Rows whose logits are all negative (padded keys have zero codes, which
    a max that did not mask them would take), and a negative scale, which
    makes the row max the scaled int32 minimum."""
    q, k, v = (_bf16(gen, 2, 200, 3, 128) for _ in range(3))
    q = q.abs()
    k[:, :, :2] = -k[:, :, :2].abs()  # heads 0 and 1: every logit of every row below 0
    out, codes = fa.flash_attention_int8(q, k, v, scale=scale, return_codes=True)
    ref, ref_codes = fa.flash_attention_int8_reference(q, k, v, scale=scale, return_codes=True)
    _check_int8(out, codes, ref, ref_codes, fa.flash_attention(q, k, v, scale=scale))


@pytest.mark.cuda
def test_int8_kernel_repeats_its_bits(gen):
    """No atomics and no order that varies: two calls give the same output and codes."""
    q, k, v = (_bf16(gen, 2, 1000, 4, 128) for _ in range(3))
    first = fa.flash_attention_int8(q, k, v, return_codes=True)
    second = fa.flash_attention_int8(q, k, v, return_codes=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _check_prologue(q, k, v, scale):
    before = fa.int8_prologue_launch_count
    got = fa.int8_attention_prologue(q, k, v, scale)
    assert fa.int8_prologue_launch_count == before + 1
    want = fa.int8_attention_operands(q, k, v, scale)
    assert got.s == want.s
    for name in ("q", "k", "v_t", "qk_scale", "v_scale"):
        a, w = getattr(got, name), getattr(want, name)
        assert a.dtype == w.dtype and a.shape == w.shape and torch.equal(a, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 1000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_prologue_equals_plain(gen, dtype, s, d):
    q, k, v = (torch.randn(2, s, 3, d, generator=gen, device="cuda").to(dtype) for _ in range(3))
    _check_prologue(q, k, v, d**-0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["slices", "transposed", "strided channels", "all zero", "one outlier"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_prologue_reads_views_and_edge_values(gen, dtype, kind):
    """Views read through their strides (16 bytes at a time, or one element
    at a time where the channels are strided); an all-zero q, whose scale is
    the 1e-12 floor; one value 1e4 times the rest."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    if kind == "slices":
        qk = rnd(2, 100, 3, 256)
        q, k, v = qk[..., :128], qk[..., 128:], rnd(2, 100, 6, 128)[:, :, ::2]
    elif kind == "transposed":
        q, k, v = (rnd(2, 3, 100, 64).transpose(1, 2) for _ in range(3))
    elif kind == "strided channels":
        q, k, v = (rnd(2, 100, 3, 128)[..., ::2] for _ in range(3))
    elif kind == "all zero":
        q, k, v = torch.zeros(2, 100, 3, 128, device="cuda", dtype=dtype), rnd(2, 100, 3, 128), rnd(2, 100, 3, 128)
        v[1, :, 2] = 0.0  # one head's v: every channel at the floor
    else:
        q, k, v = (rnd(2, 100, 3, 128) for _ in range(3))
        q[1, 37, 2, 5] = 1e4
        v[0, 99, 1, 100] = -1e4
    _check_prologue(q, k, v, 0.09)


@pytest.mark.cuda
def test_int8_kernel_rejects_what_it_does_not_take(gen):
    q = _bf16(gen, 1, 64, 2, 96)
    before = fa.int8_launch_count
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_int8(q, q, q)
    q = _bf16(gen, 1, 64, 2, 128)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        fa.flash_attention_int8(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="inference only"):
        fa.flash_attention_int8(q.clone().requires_grad_(), q, q)
    assert fa.int8_launch_count == before


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n", [(1, 64, 32), (16, 128, 64), (300, 512, 256)])
def test_int8_products_are_exact_on_the_card(gen, m, k, n):
    a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    assert torch.equal(i8.int8_mm(a, b).cpu(), i8.int8_mm(a.cpu(), b.cpu()))
    x = torch.randn(2, m, k, generator=gen, device="cuda")
    w_q, w_scale = i8.quantize_weight_int8(torch.randn(n, k, generator=gen, device="cuda"))
    got = i8.int8_linear(x, w_q, w_scale)
    assert torch.equal(got.cpu(), i8.int8_linear(x.cpu(), w_q.cpu(), w_scale.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits, group", [(2, 32), (4, 64), (8, 128)])
def test_quantize_affine_on_the_card_equals_the_cpu(gen, bits, group, dtype):
    """The scale (w_max - w_min) / levels is the true quotient, as JAX's
    ops/quant.py:quantize_affine takes it (not quantize_dit_params's lax.map
    product with 1 / levels, a pinned difference of its own). PyTorch turns a
    CUDA division by a Python number into a product with the reciprocal, one
    ulp off in places; the card must give the CPU's scales, biases and words."""
    w = (torch.randn(384, 4096, generator=gen, device="cuda") * 0.02).to(dtype)
    got = quantize_affine(w, group, bits)
    want = quantize_affine(w.cpu(), group, bits)
    for name, a, r in zip(("packed", "scales", "biases"), got, want):
        assert a.dtype == r.dtype and torch.equal(a.cpu(), r), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_merge_on_the_card_equals_the_cpu(gen, tmp_path, dtype):
    from mlx_video_tpu_torch.config import LTXModelType, LTXRopeType, tiny_test_config
    from mlx_video_tpu_torch.io.safetensors import save_safetensors
    from mlx_video_tpu_torch.lora import LoraSpec, merge_lora_into_params
    from mlx_video_tpu_torch.models.ltx.model import init_ltx_params

    cfg = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT)
    g = torch.Generator().manual_seed(1)
    model = init_ltx_params(cfg, g, device="cpu", dtype=dtype)
    state = {}
    for i in range(cfg.num_layers):
        for lin in ("attn1.to_q", "attn1.to_out.0", "attn2.to_k", "attn2.to_v"):
            key = f"diffusion_model.transformer_blocks.{i}.{lin}"
            state[f"{key}.lora_A.weight"] = torch.randn(32, cfg.inner_dim, generator=g) * 0.1
            state[f"{key}.lora_B.weight"] = torch.randn(cfg.inner_dim, 32, generator=g) * 0.1
    save_safetensors(tmp_path / "a.safetensors", state)
    specs = [LoraSpec(tmp_path / "a.safetensors", 0.75)]
    want = merge_lora_into_params(model, specs).state_dict()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = merge_lora_into_params(copy.deepcopy(model).to("cuda"), specs).state_dict()
        assert torch.backends.cuda.matmul.allow_tf32  # the caller's setting comes back
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        ulps = (got[k].cpu().view(bits).long() - v.view(bits).long()).abs()
        assert ulps.max().item() <= 1, k
        if dtype == torch.bfloat16:
            assert (ulps > 0).sum().item() <= 1e-4 * ulps.numel(), k


def _narrow_av_config():
    """A 2-layer AudioVideo DiT whose heads the kernels take (64 wide, both
    streams), with 128-wide audio tokens."""
    import dataclasses

    from mlx_video_tpu_torch.config import LTXModelType, LTXRopeType, tiny_test_config

    return dataclasses.replace(
        tiny_test_config(LTXModelType.AudioVideo, rope_type=LTXRopeType.SPLIT),
        num_attention_heads=2, attention_head_dim=64, audio_num_attention_heads=2, audio_attention_head_dim=64,
        audio_cross_attention_dim=128, audio_in_channels=128, audio_out_channels=128, double_precision_rope=True,
    )


@pytest.mark.cuda
def test_narrow_av_slice_on_the_card_matches_the_cpu(gen):
    """Two joint distilled steps of a narrow AudioVideo DiT, bf16 on the card
    (K1 for both self-attentions) against fp32 on the CPU: per-frame PSNR of
    the video latents and PSNR of the audio latents >= 35 dB, the repo's
    pipeline gate."""
    import math

    from mlx_video_tpu_torch.models.ltx.model import init_ltx_params
    from mlx_video_tpu_torch.pipelines import denoise as dn
    from mlx_video_tpu_torch.pipelines.positions import create_audio_position_grid, create_position_grid

    cfg = _narrow_av_config()
    model = init_ltx_params(cfg, torch.Generator().manual_seed(3), device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "scale_shift_table" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    x = dict(latents=torch.randn(1, 16, 2, 4, 4, generator=g), audio_latents=torch.randn(1, 8, 6, 16, generator=g),
             context=torch.randn(1, 8, 48, generator=g), audio_context=torch.randn(1, 8, 48, generator=g))
    pos = torch.from_numpy(create_position_grid(1, 2, 4, 4))
    apos = torch.from_numpy(create_audio_position_grid(1, 6))
    sigmas = [1.0, 0.725, 0.0]

    def run(m, device, dtype):
        t = {k: v.to(device, dtype) for k, v in x.items()}
        return dn.denoise(m, cfg, t["latents"], pos.to(device), t["context"], sigmas, audio_latents=t["audio_latents"],
                          audio_positions=apos.to(device), audio_context=t["audio_context"])

    ref_v, ref_a = run(model, "cpu", torch.float32)
    before = fa.launch_count
    got_v, got_a = run(copy.deepcopy(model).to("cuda", torch.bfloat16), "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    assert fa.launch_count - before == 2 * 2 * 2  # layers x steps x (video, audio)

    def psnr(a, b):
        peak = b.abs().max().item()
        mse = (a.float().cpu() - b).square().mean().item()
        return math.inf if mse == 0 else 10 * math.log10(peak * peak / mse)

    assert min(psnr(got_v[:, :, i], ref_v[:, :, i]) for i in range(2)) >= 35.0
    assert psnr(got_a, ref_a) >= 35.0
