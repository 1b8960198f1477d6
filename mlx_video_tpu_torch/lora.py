"""LoRA adapters: the offline merge of adapter files into a model's dense
weights for generation; for training, injection, the trainable mask, export
in the reference adapter format, and loading an adapter back to continue
training.

Counterpart of mlx_video_tpu/lora.py (``LoraSpec`` and
``merge_lora_into_params``; ``inject_lora``, ``lora_mask``,
``export_lora_state`` / ``save_lora`` and ``load_lora_into_params``). The JAX package keeps the factors as extra leaves
of a linear's param dict, stacked (L, ...) over the blocks; here they are
attributes of each ``Linear`` / ``QuantLinear`` / ``Int8Linear`` module:
``lora_A`` (r, in) and ``lora_B`` (out, r) fp32 parameters and a
``lora_scale`` fp32 buffer (alpha / rank), which ops/linear.py:linear applies. io/jax_bridge.py stacks
and unstacks them like every other block leaf.

Runtime adapters and slots over a quantized base are not ported yet.
"""

from __future__ import annotations

import copy
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from mlx_video_tpu_torch.config import LTXModelConfig
from mlx_video_tpu_torch.io.safetensors import SafetensorsReader, save_safetensors
from mlx_video_tpu_torch.io.weights import dit_tree_path, sanitize_pt_key
from mlx_video_tpu_torch.ops.linear import Int8Linear, Linear, QuantLinear

DEFAULT_TARGET_MODULES = (
    "to_q",
    "to_k",
    "to_v",
    "to_out",
    "ff.proj_in",
    "ff.proj_out",
    "audio_ff.proj_in",
    "audio_ff.proj_out",
    "audio_attn1",
    "audio_attn2",
    "audio_to_video_attn",
    "video_to_audio_attn",
)

LORA_PARAMS = ("lora_A", "lora_B")


@dataclass(frozen=True)
class LoraSpec:
    path: Path
    strength: float = 1.0


@dataclass
class LoRAConfig:
    """(reference: mlx_trainer/lora.py:10-15)."""

    rank: int = 8
    alpha: float = 16.0
    dropout: float = 0.0
    target_modules: Optional[Tuple[str, ...]] = None


def load_lora_state(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    with SafetensorsReader(path) as r:
        return {k: r.get(k) for k in r.keys()}


def _strip_lora_prefixes(key: str) -> str:
    for prefix in ("model.diffusion_model.", "diffusion_model."):
        if key.startswith(prefix):
            return key[len(prefix) :]
    return key


def iter_lora_pairs(
    lora_sd: Dict[str, torch.Tensor],
) -> Iterable[Tuple[str, torch.Tensor, torch.Tensor]]:
    """Yield (sanitized base key, A (r, in), B (out, r)) for each LoRA pair."""
    for key in lora_sd:
        if not key.endswith(".lora_A.weight"):
            continue
        prefix = key[: -len(".lora_A.weight")]
        key_b = f"{prefix}.lora_B.weight"
        if key_b not in lora_sd:
            continue
        base = _strip_lora_prefixes(prefix) + ".weight"
        base = sanitize_pt_key("model.diffusion_model." + base) or base
        yield base[: -len(".weight")], lora_sd[key], lora_sd[key_b]


def _locate_linear(model: nn.Module, sanitized_module: str) -> Optional[nn.Module]:
    """The linear of ``model`` that a sanitized module key names, or None
    where the model has none there."""
    mapped = dit_tree_path(sanitized_module + ".weight")
    if mapped is None:
        return None
    try:
        layer = model.get_submodule(mapped[: -len(".weight")])
    except AttributeError:
        return None
    return layer if isinstance(layer, (Linear, QuantLinear, Int8Linear)) else None


@contextmanager
def _full_fp32_matmul():
    """fp32 products without TF32 for the duration (the JAX merge's numpy
    fp32 product); the caller's setting comes back after. Only the
    ``allow_tf32`` flag is touched: PyTorch refuses to read the matmul
    precision once its older and newer precision settings were mixed."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@torch.no_grad()
def merge_lora_into_params(model: nn.Module, lora_specs: Sequence[LoraSpec], verbose: bool = False) -> nn.Module:
    """Offline merge: W += strength * (B @ A) on each dense (out, in) weight
    that an adapter names, computed in fp32 and cast back to W's dtype, one
    spec after the other. As in the JAX package, only ``strength`` scales the
    product (never alpha / rank), and a pair whose linear is quantized
    (``QuantLinear``, ``Int8Linear``: use runtime adapters) or absent is
    skipped and counted; ``[LoRA] {path} applied=N skipped=M`` is printed when
    ``verbose`` or when nothing was applied.

    Returns a new model and leaves ``model`` unchanged. The new model shares
    every parameter and buffer that the merge does not write, so it costs
    only the merged weights."""
    shared = {id(t): t for t in (*model.parameters(), *model.buffers())}
    merged = copy.deepcopy(model, memo=shared)
    for spec in lora_specs:
        applied = skipped = 0
        for module_key, a, b in iter_lora_pairs(load_lora_state(spec.path)):
            layer = _locate_linear(merged, module_key)
            if not isinstance(layer, Linear):
                skipped += 1
                continue
            w = layer.weight
            with _full_fp32_matmul():
                delta = (b.to(w.device, torch.float32) @ a.to(w.device, torch.float32)) * spec.strength
            layer.weight = nn.Parameter((w.float() + delta).to(w.dtype), requires_grad=w.requires_grad)
            applied += 1
        if verbose or applied == 0:
            print(f"[LoRA] {spec.path} applied={applied} skipped={skipped}")
    return merged


def _module_matches(path_parts: Tuple[str, ...], targets: Sequence[str]) -> bool:
    path = ".".join(path_parts)
    return any(path.endswith(t) or f".{t}." in path + "." for t in targets)


def _device(layer: nn.Module) -> torch.device:
    if isinstance(layer, QuantLinear):
        return layer.quant_weight.device
    return layer.int8_weight.device if isinstance(layer, Int8Linear) else layer.weight.device


def add_lora_(layer: nn.Module, a: torch.Tensor, b: torch.Tensor, scale: float) -> None:
    """Give ``layer`` (or replace) the trainable factors ``a`` (r, in) and
    ``b`` (out, r) and the buffer ``lora_scale``."""
    layer.lora_A = nn.Parameter(a, requires_grad=True)
    layer.lora_B = nn.Parameter(b, requires_grad=True)
    layer.register_buffer("lora_scale", torch.tensor(scale, dtype=torch.float32, device=a.device))


def inject_lora(
    model: nn.Module,
    config: LTXModelConfig,
    lora_config: LoRAConfig,
    generator: torch.Generator,
    dtype=torch.float32,
) -> nn.Module:
    """Give every linear whose path matches the target modules trainable
    factors, in place: A ~ N(0, 0.01) drawn from ``generator``, B = 0, both
    ``dtype``, and ``lora_scale`` = alpha / rank. A module path matches as in
    the JAX package, on its JAX pytree path (the layer index left out:
    ``blocks.3.attn1.to_q`` matches as ``blocks.attn1.to_q``). A layer that
    already carries factors gets fresh ones. Returns ``model``."""
    targets = lora_config.target_modules or DEFAULT_TARGET_MODULES
    rank = lora_config.rank
    scale = lora_config.alpha / rank if rank > 0 else 1.0
    for name, layer in model.named_modules():
        if not isinstance(layer, (Linear, QuantLinear, Int8Linear)):
            continue
        if not _module_matches(tuple(p for p in name.split(".") if not p.isdigit()), targets):
            continue
        out_dim, in_dim = layer.out_features, layer.in_features
        device = _device(layer)
        a = torch.randn((rank, in_dim), generator=generator, device=generator.device, dtype=torch.float32) * 0.01
        add_lora_(layer, a.to(device=device, dtype=dtype), torch.zeros((out_dim, rank), device=device, dtype=dtype),
                  scale)
    return model


def lora_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: True for the LoRA factors} (the optax trainable mask
    of the JAX package)."""
    return {name: name.rsplit(".", 1)[-1] in LORA_PARAMS for name, _ in model.named_parameters()}


def export_lora_state(model: nn.Module, config: LTXModelConfig) -> Dict[str, torch.Tensor]:
    """The factors in the reference checkpoint format,
    ``diffusion_model.<sanitized path>.lora_{A,B}.weight`` (block ``i`` as
    ``transformer_blocks.i``), fp32 on the CPU."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in model.named_parameters():
        module, _, which = name.rpartition(".")
        if which not in LORA_PARAMS:
            continue
        parts = module.split(".")
        if parts[0] == "blocks":
            key = ".".join(["transformer_blocks"] + parts[1:])
        elif parts[0] == "video":
            key = ".".join(parts[1:])
        elif parts[0] == "audio":
            key = "audio_" + ".".join(parts[1:])
        elif parts[0] == "av":
            key = ".".join([f"{parts[1]}_single"] + parts[2:])
        else:
            raise ValueError(f"no reference name for the adapter at {module}")
        out[f"diffusion_model.{key}.{which}.weight"] = p.detach().float().cpu()
    return out


def save_lora(path: Union[str, Path], model: nn.Module, config: LTXModelConfig) -> None:
    save_safetensors(path, export_lora_state(model, config))


def load_lora_into_params(model: nn.Module, path: Union[str, Path], config: LTXModelConfig) -> nn.Module:
    """REPLACE the injected factors by those of a saved adapter file
    (:func:`save_lora` / reference ``lora_step_N.safetensors``), in place:
    continue-training semantics. :func:`inject_lora` must have run; its
    shapes check the file's rank and geometry. As in the JAX package, a block
    linear the file covers for some layers gets zero factors in the others."""
    grouped: Dict[Tuple[Optional[str], str], Dict[Optional[int], Tuple[torch.Tensor, torch.Tensor]]] = {}
    for module_key, a, b in iter_lora_pairs(load_lora_state(path)):
        mapped = dit_tree_path(module_key + ".weight")
        if mapped is None:
            continue
        parts = mapped[: -len(".weight")].split(".")
        if parts[0] == "blocks":
            grouped.setdefault(("blocks", ".".join(parts[2:])), {})[int(parts[1])] = (a, b)
        else:
            grouped.setdefault((None, ".".join(parts)), {})[None] = (a, b)
    if not grouped:
        raise ValueError(f"{path}: no LoRA pairs found (not an adapter checkpoint?)")

    for (stack, rel), layers in grouped.items():
        names = [rel] if stack is None else [f"blocks.{i}.{rel}" for i in range(config.num_layers)]
        for i, name in enumerate(names):
            try:
                layer = model.get_submodule(name)
            except AttributeError:
                layer = None
            if layer is None or getattr(layer, "lora_A", None) is None:
                raise ValueError(f"{path}: adapter targets {name} but no LoRA factors are injected there — "
                                 "check lora_rank/target_modules")
            pair = layers.get(None if stack is None else i)
            a, b = pair if pair is not None else (torch.zeros_like(layer.lora_A), torch.zeros_like(layer.lora_B))
            if a.shape != layer.lora_A.shape or b.shape != layer.lora_B.shape:
                raise ValueError(
                    f"{path}: adapter shapes A{tuple(a.shape)}/B{tuple(b.shape)} at {name} do not match the "
                    f"injected A{tuple(layer.lora_A.shape)}/B{tuple(layer.lora_B.shape)} (different lora_rank?)"
                )
            with torch.no_grad():
                layer.lora_A.copy_(a)
                layer.lora_B.copy_(b)
    return model


def attach_lora_leaves(module: nn.Module, state: Dict[str, torch.Tensor]) -> nn.Module:
    """For each ``<name>.lora_A`` in a state dict, give the linear ``<name>``
    zero factors of the state's shapes (to be filled by ``load_state_dict``)
    if it has none yet; returns ``module``."""
    for key, a in state.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf != "lora_A":
            continue
        layer = module.get_submodule(prefix)
        if getattr(layer, "lora_A", None) is None:
            device = _device(layer)
            b = state[f"{prefix}.lora_B" if prefix else "lora_B"]
            add_lora_(layer, torch.zeros(a.shape, device=device), torch.zeros(b.shape, device=device), 0.0)
    return module
