"""W8A8 execution: int8 x int8 -> int32 matmuls with per-token activation
scales.

Counterpart of mlx_video_tpu/ops/int8.py. Weights are quantized symmetric
per output channel (:func:`quantize_weight_int8`), activations per token at
run time, the product accumulates in int32 and is rescaled in fp32. The JAX
package leaves the product to XLA (no Pallas kernel); here it is
``torch._int_mm`` (cuBLASLt on the card, exact int32 on the CPU) through
:func:`int8_mm`.

Layouts: the port's int8 weights are ``(out, in)``, PyTorch's linear layout;
the JAX W8A8 leaves are ``(in, out)`` and its in-graph W4A8 requantization
``(out, in)``. :func:`int8_act_matmul` takes both, by ``w_in_axis`` as in JAX
(1, the port's, by default); io/jax_bridge.py transposes the stored leaves.

:func:`quantize_params_w8a8` rewrites a DiT's transformer-block linears
("core" scope) in place; :func:`quantize_text_encoder_w8a8` rewrites the
Gemma-3 layer stack's projections and the 49-state aggregation matmul of a
text encoder. Both replace each ``Linear`` by an ``Int8Linear`` one layer at a
time, so the dense weights are never held twice beside the codes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# int8 products computed so far (each int8_act_matmul forward: a W8A8 or a
# W4A8 linear). A run resets it to 0 and reads it to show that its linears
# went the int8 way.
int8_matmul_count = 0

# Transformer-block linear names run in W8A8 (the JAX package's "core" scope).
_CORE_LINEAR_PARENTS = (
    "attn1", "attn2", "audio_attn1", "audio_attn2",
    "audio_to_video_attn", "video_to_audio_attn", "ff", "audio_ff",
)
_LINEAR_CHILDREN = ("to_q", "to_k", "to_v", "to_out", "proj_in", "proj_out")
_GEMMA_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact a b^T of int8 ``a`` (M, K) and ``b`` (N, K): (M, N) int32.

    On the card ``torch._int_mm`` needs more than 16 rows and K and N that
    are multiples of 8: the rows are zero-padded when there are fewer, and
    other K or N raise. On the CPU it takes every shape."""
    a = a.contiguous()
    if a.device.type != "cuda":
        return torch._int_mm(a, b.t())
    m, k = a.shape
    if k % 8 or b.shape[0] % 8:
        raise ValueError(f"int8 product on the card needs K and N divisible by 8, got K={k} N={b.shape[0]}")
    if m <= 16:
        return torch._int_mm(F.pad(a, (0, 0, 0, 17 - m)), b.t())[:m]
    return torch._int_mm(a, b.t())


def scale_from_absmax(absmax: torch.Tensor) -> torch.Tensor:
    """The symmetric int8 scale max(absmax / 127, 1e-12) of fp32 ``absmax``,
    divided as JAX divides. On the card PyTorch turns a division by a Python
    number into a product with its reciprocal, which can be one ulp off; a
    0-d tensor divisor keeps the correctly rounded quotient."""
    return torch.clamp(absmax / torch.full((), 127.0, device=absmax.device), min=1e-12)


def quantize_weight_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 codes of an (..., out, in) weight
    (the port's layout) and their fp32 (..., out) scales; the JAX function of
    the same name on the transposed (in, out) weight. Works 1024 output
    channels at a time, so the fp32 transient is a slice of the weight (the
    12B's aggregation matmul is 2.9 GB in fp32)."""
    codes, scales = [], []
    for chunk in torch.split(w, 1024, dim=-2):
        wf = chunk.float()
        scale = scale_from_absmax(wf.abs().amax(dim=-1))
        codes.append(torch.clamp(torch.round(wf / scale[..., None]), -127, 127).to(torch.int8))
        scales.append(scale)
    return torch.cat(codes, dim=-2), torch.cat(scales, dim=-1)


def quantize_rows(xf: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token (last axis) symmetric int8 codes of fp32 ``xf`` and their
    (..., 1) fp32 scales: the activation half of W8A8. With ``group`` (a
    row-parallel input: this rank holds a slice of each token's features)
    the absmax is the max over the group, so the codes are those of the
    whole token, as GSPMD computes them in JAX."""
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        absmax = group.all_reduce(absmax, "max")
    x_scale = scale_from_absmax(absmax)
    return torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8), x_scale


class _Int8ActMatmul(torch.autograd.Function):
    """fp32 y = dequant(quant(x) W_q); differentiable in x by the straight-
    through estimator of the JAX custom VJP: dx = g dequant(W) in fp32. The
    frozen int8 weight and its scales get no gradient."""

    @staticmethod
    def forward(ctx, xf, w_q, w_scale, w_in_axis: int, group=None):
        global int8_matmul_count
        w_oi = w_q if w_in_axis == 1 else w_q.t()
        x_q, x_scale = quantize_rows(xf, group)
        y = int8_mm(x_q.reshape(-1, xf.shape[-1]), w_oi).reshape(*xf.shape[:-1], w_oi.shape[0])
        if group is not None:
            y = group.all_reduce(y)  # the int32 partial products: an exact sum
        int8_matmul_count += 1
        ctx.save_for_backward(w_q, w_scale)
        ctx.w_in_axis = w_in_axis
        return y.float() * x_scale * w_scale.float()

    @staticmethod
    def backward(ctx, g):
        w_q, w_scale = ctx.saved_tensors
        gf, wf = g.float(), w_q.float()
        if ctx.w_in_axis == 0:  # (in, out)
            gx = gf @ (wf * w_scale.float()[None, :]).t()
        else:  # (out, in)
            gx = gf @ (wf * w_scale.float()[:, None])
        return gx, None, None, None, None


def int8_act_matmul(xf: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, w_in_axis: int = 1,
                    group=None) -> torch.Tensor:
    """fp32 ``dequant(quant(xf) @ w_q)``: per-token activation codes, an exact
    int32 product, then ``y * x_scale * w_scale`` in fp32. ``w_q`` is
    (out, in) for ``w_in_axis`` 1 and (in, out) for 0; ``w_scale`` (out,).
    With ``group`` (row-parallel: ``xf`` and ``w_q`` hold this rank's slice
    of the in dimension) the codes take the group's absmax and the int32
    products are summed over the group before the rescale."""
    return _Int8ActMatmul.apply(xf, w_q, w_scale, w_in_axis, group)


def int8_linear(
    x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, group=None
) -> torch.Tensor:
    """y = dequant(quant(x) W_q^T) (+ bias) in x's dtype, with ``w_q``
    (out, in) int8 and ``w_scale`` (out,) fp32; the bias is added in fp32,
    after the sum over ``group`` (row-parallel, :func:`int8_act_matmul`).
    Gradients reach x through the STE of :func:`int8_act_matmul`."""
    y = int8_act_matmul(x.float(), w_q, w_scale, 1, group)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def to_int8_linear(layer: nn.Module) -> nn.Module:
    """A dense ``Linear`` -> an ``Int8Linear`` on the same device with the
    same bias and LoRA factors (the JAX conversion keeps every leaf but
    ``weight``)."""
    from mlx_video_tpu_torch.ops.linear import Int8Linear

    out = Int8Linear(layer.in_features, layer.out_features, bias=layer.bias is not None, device="meta")
    out.int8_weight, out.int8_scale = quantize_weight_int8(layer.weight.detach())
    out.bias = layer.bias
    for name in ("lora_A", "lora_B"):
        if getattr(layer, name, None) is not None:
            setattr(out, name, getattr(layer, name))
    if getattr(layer, "lora_scale", None) is not None:
        out.register_buffer("lora_scale", layer.lora_scale)
    return out


def use_int8_linears(module: nn.Module, state: dict) -> nn.Module:
    """For a state dict that holds int8 leaves: each dense ``Linear`` with a
    ``<name>.int8_weight`` becomes an uninitialised ``Int8Linear`` on its
    device, and each ``QuantLinear`` with a ``<name>.int8_scale`` gets an
    empty W4A8 scale buffer, in place, so ``load_state_dict`` can fill them.
    Returns ``module``."""
    from mlx_video_tpu_torch.ops.linear import Int8Linear, Linear, QuantLinear

    for key in state:
        name, _, leaf = key.rpartition(".")
        if leaf not in ("int8_weight", "int8_scale"):
            continue
        layer = module.get_submodule(name)
        if leaf == "int8_weight" and isinstance(layer, Linear):
            parent_name, _, child = name.rpartition(".")
            device, dtype = layer.weight.device, layer.weight.dtype
            setattr(module.get_submodule(parent_name), child, Int8Linear(
                layer.in_features, layer.out_features, bias=layer.bias is not None, device=device, dtype=dtype))
        elif leaf == "int8_scale" and isinstance(layer, QuantLinear):
            layer.register_buffer("int8_scale", torch.empty(
                layer.out_features, dtype=torch.float32, device=layer.quant_weight.device))
    return module


def _replace(model: nn.Module, names) -> nn.Module:
    for name in names:
        parent_name, _, child = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        setattr(parent, child, to_int8_linear(getattr(parent, child)))
    return model


@torch.no_grad()
def quantize_params_w8a8(model: nn.Module) -> nn.Module:
    """Rewrite the DiT's transformer-block linears to ``Int8Linear`` IN PLACE
    and return ``model``: a dense ``Linear`` named ``to_q``, ``to_k``,
    ``to_v``, ``to_out``, ``proj_in`` or ``proj_out`` under an ``attn1``,
    ``attn2``, ``ff`` (or audio) parent, as the JAX walk picks them.
    Patchify, adaLN, caption projection and output projection stay dense;
    a linear held quantized (``QuantLinear``) stays as it is."""
    from mlx_video_tpu_torch.ops.linear import Linear

    names = []
    for name, m in model.named_modules():
        parts = [p for p in name.split(".") if not p.isdigit()]
        if (isinstance(m, Linear) and parts[-1] in _LINEAR_CHILDREN
                and any(p in _CORE_LINEAR_PARENTS for p in parts[:-1])):
            names.append(name)
    return _replace(model, names)


@torch.no_grad()
def quantize_text_encoder_w8a8(encoder: nn.Module) -> nn.Module:
    """Rewrite a text encoder (models/ltx/text_encoder.py:TextEncoderModel)
    IN PLACE and return it: the Gemma-3 layers' attention and MLP
    projections and the feature extractor's aggregation matmul become
    ``Int8Linear``; embeddings, norms and the connectors stay dense."""
    from mlx_video_tpu_torch.ops.linear import Linear

    names = [
        name for name, m in encoder.named_modules()
        if isinstance(m, Linear) and (
            (name.startswith("language_model.layers.") and name.rsplit(".", 1)[-1] in _GEMMA_LINEARS)
            or name == "feature_extractor.aggregate_embed"
        )
    ]
    return _replace(encoder, names)
