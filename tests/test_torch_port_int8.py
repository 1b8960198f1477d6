"""The port's int8 execution against the JAX package, on the CPU: the int8
attention's plain version (K6's), W8A8 and W4A8 linears with their
straight-through gradients, W8A8 and W4A8 DiTs, ``quantize_models`` and the
native int8 checkpoint.

Inputs come from seeded numpy generators and go to both sides. Bars, each
with its reason:
- K6's plain version against ``flash_attention_int8(interpret=True)``:
  relative L2 <= 1e-4. The integer products are exact on both sides, so
  only p_q codes whose 127 exp(.) lands within an ulp of a half can differ;
  on these inputs none did (0 of 312,182 codes, every code 0..127 present;
  the bar allows 1e-4 of them);
- int8 codes (weights, activations, W4A8 requantization) equal bit for bit;
  scales within one fp32 ulp;
- W8A8 and W4A8 linears: y within 1e-5 of max |y| (the same int32 products,
  fp32 rescales in the same order), their STE gradients within 1e-4 of the
  JAX VJP (fp32 matmuls summed in another order);
- a 4-layer tiny DiT in W8A8 and in W4A8 (ltx_apply): relative L2 <= 1e-3.
  Weights are N(0, 0.03^2): there the dense port and JAX agree to 3e-7 and
  the int8 ones to 3e-7. At N(0, 0.1^2) the 4 layers amplify the dense
  difference to 5e-6, enough to move activation codes across a half, and
  one moved code moves a linear's output by ~1e-3: W8A8 then reads 1.2e-2;
- the native int8 file: bit-exact;
- the identities K6's CUDA kernel relies on (csrc/flash_attention_int8.cu),
  in numpy float32: exact, so equal.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_video_tpu import loading as jloading
from mlx_video_tpu.config import LTXModelType, LTXRopeType, tiny_test_config
from mlx_video_tpu.io import weights as jweights
from mlx_video_tpu.models.ltx import model as jm
from mlx_video_tpu.ops import int8 as jint8
from mlx_video_tpu.ops import linear as jlinear
from mlx_video_tpu.ops import quant as jquant
from mlx_video_tpu.ops.flash_attention import flash_attention_int8 as jax_flash_int8
from mlx_video_tpu.pipelines.positions import create_position_grid
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch import loading as tloading
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.io import weights as tweights
from mlx_video_tpu_torch.lora import LoRAConfig, inject_lora
from mlx_video_tpu_torch.models.ltx import model as tm
from mlx_video_tpu_torch.ops import flash_attention as fa
from mlx_video_tpu_torch.ops import int8 as tint8
from mlx_video_tpu_torch.ops import linear as tlinear
from mlx_video_tpu_torch.ops import quant as tquant
from mlx_video_tpu_torch.pipelines.generate import ModelBundle

ULP = np.finfo(np.float32).eps


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# K6: the int8 attention's plain version
# ---------------------------------------------------------------------------


def _jax_p_codes(q, k, v, scale):
    """p_q of the JAX function, computed with its own prologue and kernel
    arithmetic in jnp (the Pallas kernel does not return them)."""
    b, s, h, d = q.shape

    def heads(x):
        return jnp.transpose(jnp.asarray(x, jnp.float32), (0, 2, 1, 3)).reshape(b * h, s, d)

    def quant(x):
        sc = jnp.maximum(jnp.max(jnp.abs(x)) / 127.0, 1e-12)
        return jnp.clip(jnp.round(x / sc), -127, 127).astype(jnp.int8), sc

    (qq, sq), (kq, sk) = quant(heads(q)), quant(heads(k))
    logits = jax.lax.dot_general(qq, kq, (((2,), (2,)), ((0,), (0,))), preferred_element_type=jnp.int32)
    logits = logits.astype(jnp.float32) * (sq * sk * scale).astype(jnp.float32)
    p = jnp.exp(logits - jnp.max(logits, axis=-1, keepdims=True))
    return np.asarray(jnp.round(p * 127.0).astype(jnp.int8))


@pytest.mark.parametrize("b, s, h, d", [(1, 200, 2, 64), (1, 256, 2, 128), (2, 77, 3, 128), (1, 128, 4, 64)])
def test_int8_attention_plain_matches_jax(b, s, h, d):
    """S ragged and S a block multiple, D 64 and 128."""
    rng = np.random.default_rng(s + d)
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    q[:, ::5] *= 4.0  # a few peaked rows: p_q then spans 0..127
    ref = np.asarray(jax_flash_int8(*(jnp.asarray(x) for x in (q, k, v)), interpret=True))
    before = fa.int8_launch_count
    got, codes = fa.flash_attention_int8(*(torch.from_numpy(x) for x in (q, k, v)), return_codes=True)
    assert fa.int8_launch_count == before  # the CPU takes the plain version
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert _rel_l2(got.numpy(), ref) <= 1e-4
    flips = int((codes.numpy() != _jax_p_codes(q, k, v, d**-0.5)).sum())
    assert flips <= 1e-4 * codes.numel(), flips


def test_int8_attention_bf16_and_its_quantization_error():
    """bf16 in, bf16 out; against exact attention the error is the JAX
    test's ~2-3 % by design (bar 5e-2)."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 256, 4, 128)).astype(np.float32)).bfloat16() for _ in range(3))
    out = fa.flash_attention_int8(q, k, v)
    assert out.dtype == torch.bfloat16
    ref = fa.flash_attention_reference(q, k, v, 128**-0.5)
    assert _rel_l2(out.float().numpy(), ref.float().numpy()) < 5e-2


def test_int8_attention_is_inference_only():
    q = torch.randn(1, 16, 2, 64, requires_grad=True)
    with torch.enable_grad(), pytest.raises(ValueError, match="inference only"):
        fa.flash_attention_int8(q, q.detach(), q.detach())
    with torch.no_grad():
        assert fa.flash_attention_int8(q, q, q).shape == q.shape


def test_int8_operands_pad_and_transpose():
    """K6's operands: codes zero-padded to a multiple of 64 rows, v's codes
    transposed to (B*H, D, S_pad), one v scale per (head, channel)."""
    q, v = torch.randn(2, 70, 3, 64), torch.randn(2, 70, 3, 64) * torch.linspace(0.1, 4, 64)
    ops = fa.int8_attention_operands(q, q, v, 0.125)
    assert ops.q.shape == (6, 128, 64) and ops.v_t.shape == (6, 64, 128) and ops.v_scale.shape == (6, 64)
    assert not ops.q[:, 70:].any() and not ops.v_t[:, :, 70:].any()
    vh = v.permute(0, 2, 1, 3).reshape(6, 70, 64)
    torch.testing.assert_close(ops.v_scale, vh.abs().amax(dim=1) / 127.0, rtol=0, atol=0)
    assert torch.equal(ops.v_t[:, :, :70], torch.round(vh / ops.v_scale[:, None]).to(torch.int8).transpose(1, 2))
    assert ops.qk_scale.dtype == torch.float32 and ops.qk_scale.dim() == 0


def test_int8_prologue_on_the_cpu_is_the_plain_prologue():
    q, k, v = (torch.randn(2, 70, 3, 64) for _ in range(3))
    before = fa.int8_prologue_launch_count
    got, want = fa.int8_attention_prologue(q, k, v, 0.125), fa.int8_attention_operands(q, k, v, 0.125)
    assert fa.int8_prologue_launch_count == before
    assert got.s == want.s and all(torch.equal(a, b) for a, b in zip(got[:5], want[:5]))


# ---------------------------------------------------------------------------
# The exact identities K6's CUDA kernel relies on
# ---------------------------------------------------------------------------

_MAGIC_BITS = np.int32(0x4B400000)  # the bits of 1.5 * 2^23
_MAGIC = np.float32(12582912.0)
_K6_SOURCE = Path(fa.__file__).resolve().parent.parent / "csrc" / "flash_attention_int8.cu"


def test_magic_int_to_float_is_exact():
    """Every logit |s| <= 127^2 * 128 (D = 128): float(s) as
    __int_as_float(0x4B400000 + s) - 1.5 * 2^23, on the FMA pipe."""
    s = np.arange(-(127**2) * 128, 127**2 * 128 + 1, dtype=np.int32)
    f = (s + _MAGIC_BITS).view(np.float32) - _MAGIC
    assert f.dtype == np.float32 and np.array_equal(f, s.astype(np.float32))


def test_magic_round_half_to_even_is_rint():
    """127 p for a dense sample of p in [0, 1], exact halves and their
    neighbours: the bits of 127 p + 1.5 * 2^23, less 0x4B400000, are rint's
    integer, and the low byte alone is the code."""
    p = np.linspace(0.0, 1.0, 2_000_001, dtype=np.float32)
    halves = np.arange(127, dtype=np.float32) + np.float32(0.5)
    y = np.concatenate([p * np.float32(127.0), halves, np.nextafter(halves, np.float32(0)),
                        np.nextafter(halves, np.float32(200)), np.arange(128, dtype=np.float32)])
    code = (y + _MAGIC).view(np.int32) - _MAGIC_BITS
    assert np.array_equal(code, np.rint(y).astype(np.int32))
    assert np.array_equal((y + _MAGIC).view(np.int32) & 0xFF, code)


@pytest.mark.parametrize("sign", [1, -1])
def test_masked_int32_extreme_scaled_is_the_max_logit(sign):
    """Pass 1 keeps only the int32 extreme of a row: fp32(max s) * qk (the min
    for a negative qk) equals the max of the fp32 logits fp32(s) * qk, keys
    past S masked to INT_MIN (INT_MAX). Rows with ties, all-negative rows
    and the full |s| range; without the mask, the padded keys' zero logits
    win over the all-negative rows."""
    rng = np.random.default_rng(7)
    valid, keys = 250, 320
    s = rng.integers(-(127**2) * 128, 127**2 * 128 + 1, (96, keys)).astype(np.int32)
    s[:16] = rng.integers(-40, 40, (16, keys))  # many ties
    s[16:32] = -np.abs(s[16:32]) - 1  # every logit negative
    s[32:40] = 5  # all equal
    s[:, valid:] = 0  # padded keys: zero codes
    for qk in sign * rng.uniform(1e-4, 1.0, 20).astype(np.float32):
        want = (s[:, :valid].astype(np.float32) * qk).max(axis=1)
        fill = np.iinfo(np.int32).min if qk >= 0 else np.iinfo(np.int32).max
        masked = np.where(np.arange(keys) < valid, s, fill)
        ext = masked.max(axis=1) if qk >= 0 else masked.min(axis=1)
        assert np.array_equal(ext.astype(np.float32) * qk, want)
        unmasked = s.max(axis=1) if qk >= 0 else s.min(axis=1)
        assert not np.array_equal(unmasked.astype(np.float32) * qk, want)


def _byte_perm(x: int, y: int, sel: int) -> int:
    src = x.to_bytes(4, "little") + y.to_bytes(4, "little")
    return int.from_bytes(bytes(src[(sel >> (4 * i)) & 7] for i in range(4)), "little")


def test_p_fragment_permutation_gives_the_a_layout():
    """codes_to_a, with the selectors read from the kernel's source: in a
    16-key half, thread t of a quad holds keys 2t, 2t + 1 and 8 + 2t, 9 + 2t
    of rows g and g + 8 (the s32 accumulator); after the exchange with lane
    t ^ 1 and the swap of threads 1 and 2 it holds keys 4t .. 4t + 3 of each
    row (the s8 A fragment)."""
    src = _K6_SOURCE.read_text()
    sel_g8 = re.search(r"sel_g8 = odd \? (0x[0-9A-Fa-f]+) : (0x[0-9A-Fa-f]+);", src)
    sel_g = re.search(r"sel_g = odd \? (0x[0-9A-Fa-f]+) : (0x[0-9A-Fa-f]+);", src)
    low = re.search(r"__byte_perm\(__byte_perm\(a, b, (0x[0-9A-Fa-f]+)\), __byte_perm\(c, d, \1\), "
                    r"(0x[0-9A-Fa-f]+)\)", src)
    assert sel_g and sel_g8 and low
    sel = {row: [int(m.group(2), 16), int(m.group(1), 16)] for row, m in ((0, sel_g), (8, sel_g8))}  # [even, odd]
    pick, join = int(low.group(1), 16), int(low.group(2), 16)

    def code(row, key):  # a distinct byte for every (row, key) of the half
        return 16 * (row // 8) + key

    def low_bytes(a, b, c, d):
        return _byte_perm(_byte_perm(a, b, pick), _byte_perm(c, d, pick), join)

    # accumulator block c holds (row g, key 8c + 2t + e) at 4c + e and (row g + 8, ...) at 4c + 2 + e
    acc = [[code(8 * r, 8 * c + 2 * t + e) for c in range(2) for r in range(2) for e in range(2)] for t in range(4)]
    x = [low_bytes(*acc[t][0:4]) for t in range(4)]
    y = [low_bytes(*acc[t][4:8]) for t in range(4)]
    keep = [y[t] if t & 1 else x[t] for t in range(4)]
    send = [x[t] if t & 1 else y[t] for t in range(4)]
    swap = [0, 2, 1, 3]
    for row in (0, 8):
        exchanged = [_byte_perm(keep[t], send[t ^ 1], sel[row][t & 1]) for t in range(4)]
        for t in range(4):
            want = [code(row, 4 * t + i) for i in range(4)]
            assert list(exchanged[swap[t]].to_bytes(4, "little")) == want


# ---------------------------------------------------------------------------
# Codes and linears
# ---------------------------------------------------------------------------


def test_weight_activation_and_w4a8_codes_match_jax(rng):
    w = rng.normal(size=(96, 64)).astype(np.float32)  # (in, out), JAX's layout
    wq_j, sc_j = (np.asarray(a) for a in jint8.quantize_weight_int8(jnp.asarray(w)))
    wq_t, sc_t = tint8.quantize_weight_int8(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(wq_t.numpy(), wq_j.T)
    np.testing.assert_allclose(sc_t.numpy(), sc_j, rtol=ULP, atol=0)

    x = (rng.normal(size=(5, 7, 96)) * rng.uniform(0.1, 10, size=(5, 7, 1))).astype(np.float32)
    xj = jnp.asarray(x)
    xs_j = jnp.maximum(jnp.max(jnp.abs(xj), axis=-1, keepdims=True) / 127.0, 1e-12)
    xq_j = jnp.clip(jnp.round(xj / xs_j), -127, 127).astype(jnp.int8)
    xq_t, xs_t = tint8.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=ULP, atol=0)

    packed, scales, biases = jquant.quantize_affine(jnp.asarray(w.T), 32, 4)
    s8_j = np.asarray(jquant.prepare_w4a8({"l": {"quant_weight": packed, "scales": scales, "biases": biases}})
                      ["l"]["int8_scale"])
    s8_t = tquant.w4a8_scale(torch.from_numpy(np.asarray(scales)), torch.from_numpy(np.asarray(biases)), 4)
    np.testing.assert_allclose(s8_t.numpy(), s8_j, rtol=ULP, atol=0)


def _vjp_jax(fn, x, g):
    y, pull = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(pull(jnp.asarray(g))[0])


def _grad_port(fn, x, g):
    xt = torch.from_numpy(x).requires_grad_()
    with torch.enable_grad():
        y = fn(xt)
        (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    return y.detach().numpy(), gx.numpy()


def _close(got, ref, bar):
    assert np.abs(got - ref).max() <= bar * np.abs(ref).max()


@pytest.mark.parametrize("bias", [False, True])
def test_int8_linear_and_its_ste_match_jax(rng, bias):
    w = rng.normal(size=(64, 48)).astype(np.float32)  # (in, out)
    bvec = rng.normal(size=(48,)).astype(np.float32) if bias else None
    x = rng.normal(size=(3, 10, 64)).astype(np.float32)
    g = rng.normal(size=(3, 10, 48)).astype(np.float32)
    wq, sc = jint8.quantize_weight_int8(jnp.asarray(w))
    jb = None if bvec is None else jnp.asarray(bvec)
    y_j, gx_j = _vjp_jax(lambda xx: jint8.int8_linear(xx, wq, sc, jb), x, g)
    wq_t, sc_t = torch.from_numpy(np.asarray(wq).T.copy()), torch.from_numpy(np.asarray(sc))
    tb = None if bvec is None else torch.from_numpy(bvec)
    before = tint8.int8_matmul_count
    y_t, gx_t = _grad_port(lambda xx: tint8.int8_linear(xx, wq_t, sc_t, tb), x, g)
    assert tint8.int8_matmul_count == before + 1
    _close(y_t, y_j, 1e-5)
    _close(gx_t, gx_j, 1e-4)


@pytest.mark.parametrize("w_in_axis", [0, 1])
def test_int8_act_matmul_takes_both_layouts(rng, w_in_axis):
    w = rng.normal(size=(32, 24)).astype(np.float32)  # (in, out)
    wq, sc = jint8.quantize_weight_int8(jnp.asarray(w))
    wq_lay = wq if w_in_axis == 0 else wq.T
    x = rng.normal(size=(9, 32)).astype(np.float32)
    g = rng.normal(size=(9, 24)).astype(np.float32)
    y_j, gx_j = _vjp_jax(lambda xx: jint8.int8_act_matmul(xx, wq_lay, sc, w_in_axis), x, g)
    wq_t = torch.from_numpy(np.array(wq_lay))
    y_t, gx_t = _grad_port(lambda xx: tint8.int8_act_matmul(xx, wq_t, torch.from_numpy(np.asarray(sc)), w_in_axis),
                           x, g)
    _close(y_t, y_j, 1e-5)
    _close(gx_t, gx_j, 1e-4)


@pytest.mark.parametrize("bits, group", [(4, 64), (8, 32)])
def test_w4a8_branch_and_its_ste_match_jax(rng, bits, group):
    """A quantized linear with an int8 scale: JAX's linear() W4A8 branch."""
    w = (rng.normal(size=(128, 40)) * 0.1).astype(np.float32)  # (in, out)
    x = rng.normal(size=(2, 6, 128)).astype(np.float32)
    g = rng.normal(size=(2, 6, 40)).astype(np.float32)
    params = jquant.prepare_w4a8(jquant.quantize_linear_params({"weight": jnp.asarray(w),
                                                                "bias": jnp.full((40,), 0.5)}, group, bits), bits)
    y_j, gx_j = _vjp_jax(lambda xx: jlinear.linear(params, xx), x, g)
    layer = tlinear.QuantLinear(128, 40, bits, group)
    layer.quant_weight = torch.from_numpy(np.asarray(params["quant_weight"]).view(np.int32))
    layer.scales, layer.biases = (torch.from_numpy(np.asarray(params[n])) for n in ("scales", "biases"))
    layer.bias.data = torch.full((40,), 0.5)
    tquant.prepare_w4a8(layer, bits)
    np.testing.assert_allclose(layer.int8_scale.numpy(), np.asarray(params["int8_scale"]), rtol=ULP, atol=0)
    y_t, gx_t = _grad_port(lambda xx: tlinear.linear(layer, xx), x, g)
    _close(y_t, y_j, 1e-5)
    _close(gx_t, gx_j, 1e-4)


def test_lora_rides_on_int8_linears(rng):
    """LoRA over an Int8Linear and over a W4A8 QuantLinear: y + scale x A^T B^T,
    as JAX's _apply_lora on its int8 branches."""
    w = rng.normal(size=(64, 32)).astype(np.float32)
    a, bm = rng.normal(size=(4, 64)).astype(np.float32), rng.normal(size=(32, 4)).astype(np.float32)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    wq, sc = jint8.quantize_weight_int8(jnp.asarray(w))
    jp = {"int8_weight": wq, "int8_scale": sc, "lora_A": jnp.asarray(a), "lora_B": jnp.asarray(bm),
          "lora_scale": jnp.asarray(0.5)}
    ref = np.asarray(jlinear.linear(jp, jnp.asarray(x)))
    layer = tlinear.Int8Linear(64, 32, bias=False)
    layer.int8_weight, layer.int8_scale = torch.from_numpy(np.asarray(wq).T.copy()), torch.from_numpy(np.asarray(sc))
    layer.lora_A, layer.lora_B = torch.nn.Parameter(torch.from_numpy(a)), torch.nn.Parameter(torch.from_numpy(bm))
    layer.register_buffer("lora_scale", torch.tensor(0.5))
    _close(tlinear.linear(layer, torch.from_numpy(x)).detach().numpy(), ref, 1e-5)


# ---------------------------------------------------------------------------
# Tiny DiTs in W8A8 and W4A8
# ---------------------------------------------------------------------------


def _port(cfg):
    return tconfig.LTXModelConfig.from_dict(cfg.to_dict())


@pytest.fixture(scope="module")
def dense_dit():
    cfg = tiny_test_config(LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT, num_layers=4)
    rng = np.random.default_rng(7)
    shapes = jax.eval_shape(lambda: jm.init_ltx_params(jax.random.key(0), cfg, dtype=jnp.float32))
    dense = jax.tree.map(lambda s: (rng.normal(size=s.shape) * 0.03).astype(np.float32), shapes)
    return cfg, dense


def _forward_both(cfg, jparams, model):
    rng = np.random.default_rng(8)
    b, f, h, w = 1, 2, 4, 4
    tokens = rng.normal(size=(b, f * h * w, cfg.in_channels)).astype(np.float32)
    context = rng.normal(size=(b, 6, cfg.caption_channels)).astype(np.float32)
    ts, pos = np.full((b, 1), 0.6, np.float32), create_position_grid(b, f, h, w)
    ref, _ = jm.ltx_apply(jparams, cfg, video=jm.Modality(
        latent=jnp.asarray(tokens), timesteps=jnp.asarray(ts), context=jnp.asarray(context),
        positions=jnp.asarray(pos)))
    got, _ = tm.ltx_apply(model, _port(cfg), tm.Modality(
        latent=torch.from_numpy(tokens), timesteps=torch.from_numpy(ts), context=torch.from_numpy(context),
        positions=torch.from_numpy(pos)))
    return got.numpy(), np.asarray(ref)


def test_w8a8_dit_matches_jax(dense_dit):
    cfg, dense = dense_dit
    jparams = jint8.quantize_params_w8a8(jax.tree.map(jnp.asarray, dense))
    model = tm.LTXModel(_port(cfg), device="cpu", dtype=torch.float32)
    jax_bridge.load_jax_params(model, dense)
    assert tint8.quantize_params_w8a8(model) is model
    int8 = [n for n, m in model.named_modules() if isinstance(m, tlinear.Int8Linear)]
    assert len(int8) == 10 * cfg.num_layers and isinstance(model.video.patchify_proj, tlinear.Linear)
    # the port's codes are JAX's, bit for bit; scales to one ulp
    ours = jax_bridge.module_to_jax_tree(model)
    for name in ("to_q", "to_out"):
        np.testing.assert_array_equal(ours["blocks"]["attn1"][name]["int8_weight"],
                                      np.asarray(jparams["blocks"]["attn1"][name]["int8_weight"]))
        np.testing.assert_allclose(ours["blocks"]["attn1"][name]["int8_scale"],
                                   np.asarray(jparams["blocks"]["attn1"][name]["int8_scale"]), rtol=ULP, atol=0)
    before = tint8.int8_matmul_count
    got, ref = _forward_both(cfg, jparams, model)
    assert tint8.int8_matmul_count == before + 10 * cfg.num_layers
    assert _rel_l2(got, ref) <= 1e-3


def test_w4a8_dit_matches_jax(dense_dit):
    cfg, dense = dense_dit
    q4 = jquant.quantize_dit_params(jax.tree.map(jnp.asarray, dense), group_size=64, bits=4)
    jparams = jquant.prepare_w4a8(q4, bits=4)
    model = tm.LTXModel(_port(cfg), device="cpu", dtype=torch.float32)
    jax_bridge.load_jax_params(model, jax.tree.map(np.asarray, q4))
    tquant.prepare_w4a8(model, bits=4)
    ours = jax_bridge.module_to_jax_tree(model)
    np.testing.assert_allclose(ours["blocks"]["ff"]["proj_in"]["int8_scale"],
                               np.asarray(jparams["blocks"]["ff"]["proj_in"]["int8_scale"]), rtol=ULP, atol=0)
    before = tint8.int8_matmul_count
    got, ref = _forward_both(cfg, jparams, model)
    assert tint8.int8_matmul_count == before + 10 * cfg.num_layers
    assert _rel_l2(got, ref) <= 1e-3


def test_bridge_carries_w4a8_scales(dense_dit):
    """A JAX W4A8 tree loads with its int8 scales and goes back bit-exact."""
    cfg, dense = dense_dit
    jparams = jax.tree.map(np.asarray, jquant.prepare_w4a8(
        jquant.quantize_dit_params(jax.tree.map(jnp.asarray, dense), group_size=64, bits=4), bits=4))
    model = jax_bridge.load_jax_params(tm.LTXModel(_port(cfg), device="cpu", dtype=torch.float32), jparams)
    back = jax_bridge.module_to_jax_tree(model)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for x, y in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_native_w8a8_file_from_jax_loads_bit_exact(dense_dit, tmp_path):
    """The native int8 checkpoint the JAX side writes (convert --w8a8's
    format): int8 codes (in, out) and fp32 scales, read back bit for bit, and
    written again byte for byte."""
    cfg, dense = dense_dit
    jparams = jint8.quantize_params_w8a8(jax.tree.map(jnp.asarray, dense))
    path = tmp_path / "w8a8.safetensors"
    jweights.save_dit_params(path, jparams)
    model = tweights.load_dit_params(path, _port(cfg), dtype=torch.float32, device="cpu")
    assert isinstance(model.blocks[1].attn2.to_v, tlinear.Int8Linear)
    assert model.blocks[1].attn2.to_v.int8_scale.dtype == torch.float32
    back = jax_bridge.module_to_jax_tree(model)
    ref = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for x, y in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    again = tmp_path / "again.safetensors"
    tweights.save_dit_params(again, model)
    assert again.read_bytes() == path.read_bytes()


# ---------------------------------------------------------------------------
# quantize_models, LoRA and the trainer over int8 bases
# ---------------------------------------------------------------------------


def _bundle(cfg, dense, quantized: bool = False):
    model = tm.LTXModel(_port(cfg), device="cpu", dtype=torch.float32)
    jax_bridge.load_jax_params(model, dense)
    if quantized:
        tquant.quantize_dit_params(model, group_size=64, bits=8)
    return ModelBundle(model, _port(cfg), None, None)


@pytest.mark.parametrize("quantize_bits, meta, hint, want", [
    (None, None, "", 4), (None, None, "org/ltx2-distilled-8bit-mlx", 8), (None, {"bits": 8}, "x-4bit", 8),
    (8, None, "x-4bit", 8), (None, {"group_size": 64}, "", 4),
])
def test_quantize_models_resolves_the_stored_bits(dense_dit, tmp_path, quantize_bits, meta, hint, want):
    """flag > quantization.json > repo-name hint > 4, as the JAX function."""
    cfg, dense = dense_dit
    if meta is not None:
        (tmp_path / "quantization.json").write_text(json.dumps(meta))
    models = _bundle(cfg, dense)
    tloading.quantize_models(models, tmp_path, w4a8=True, quantize_bits=quantize_bits, repo_hint=hint)
    layers = [m for m in models.transformer.modules() if isinstance(m, tlinear.QuantLinear)]
    assert len(layers) == 10 * cfg.num_layers and {m.bits for m in layers} == {want}
    assert all(m.int8_scale.shape == (m.out_features,) for m in layers)
    # the JAX function picks the same width
    jmodels = jloading.ModelBundle(jax.tree.map(jnp.asarray, dense), cfg, None, None)
    jloading.quantize_models(jmodels, tmp_path, w4a8=True, quantize_bits=quantize_bits, repo_hint=hint)
    words = jmodels.transformer_params["blocks"]["ff"]["proj_in"]["quant_weight"].shape[-1]
    assert words * 32 // 128 == want


def test_quantize_models_keeps_a_prequantized_base_and_refuses_conflicts(dense_dit, tmp_path):
    cfg, dense = dense_dit
    models = _bundle(cfg, dense, quantized=True)
    tloading.quantize_models(models, tmp_path, w4a8=True)
    assert {m.bits for m in models.transformer.modules() if isinstance(m, tlinear.QuantLinear)} == {8}
    (tmp_path / "quantization.json").write_text(json.dumps({"bits": 8}))
    with pytest.raises(ValueError, match="conflicts"):
        tloading.quantize_models(_bundle(cfg, dense), tmp_path, w4a8=True, quantize_bits=4)
    with pytest.raises(ValueError, match="exclusive"):
        tloading.quantize_models(_bundle(cfg, dense), tmp_path, w8a8=True, w4a8=True)
    models = _bundle(cfg, dense)
    tloading.quantize_models(models, tmp_path, w8a8=True)
    assert sum(isinstance(m, tlinear.Int8Linear) for m in models.transformer.modules()) == 10 * cfg.num_layers


@pytest.mark.parametrize("mode", ["w8a8", "w4a8"])
def test_lora_trains_over_an_int8_base(dense_dit, mode):
    """inject_lora reaches every int8 linear, and the adapters get gradients
    through the STE; full finetuning of an int8 base is refused."""
    from mlx_video_tpu_torch.trainer.config import TrainingConfig
    from mlx_video_tpu_torch.trainer.trainer import Trainer

    cfg, dense = dense_dit
    models = _bundle(cfg, dense)
    tloading.quantize_models(models, None, **{mode: True})
    model = models.transformer
    inject_lora(model, _port(cfg), LoRAConfig(rank=4, alpha=8.0), torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        if name.endswith("lora_B"):
            p.data.normal_(0, 0.02)
    lora = {n: p.requires_grad_() for n, p in model.named_parameters() if ".lora_" in n}
    assert len(lora) == 2 * 10 * cfg.num_layers
    rng = np.random.default_rng(9)
    video = tm.Modality(latent=torch.from_numpy(rng.normal(size=(1, 32, cfg.in_channels)).astype(np.float32)),
                        timesteps=torch.full((1, 1), 0.5),
                        context=torch.from_numpy(rng.normal(size=(1, 6, cfg.caption_channels)).astype(np.float32)),
                        positions=torch.from_numpy(create_position_grid(1, 2, 4, 4)))
    with torch.enable_grad():
        loss = tm.ltx_apply(model, _port(cfg), video)[0].square().mean()
        grads = torch.autograd.grad(loss, list(lora.values()))
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
    with pytest.raises(ValueError, match="LoRA training only"):
        Trainer(TrainingConfig(training_mode="full", steps=1, handle_preemption=False), model_config=_port(cfg),
                params=model, dataset=[None])
