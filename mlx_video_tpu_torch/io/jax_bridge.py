"""Weight bridge between the JAX package's param pytrees and the port's modules.

A JAX pytree here is a nested dict of numpy arrays (``jax.tree.map(np.asarray,
params)``), as ``init_ltx_params``, ``init_latent_upsampler`` and
``init_video_decoder`` build it, or of torch tensors in the same layout, as a
native checkpoint reads (io/weights.py). The port's modules keep the same
names, so the mapping is mechanical:

- subtrees named ``blocks``, ``res_blocks`` and ``post_upsample_res_blocks``
  are stacked along a leading layer axis in JAX and are ``nn.ModuleList``s
  here: layer ``i`` becomes the path component ``.i``;
- a ``weight`` leaf changes layout: linear (in, out) -> (out, in), 2D conv
  (kh, kw, I, O) -> (O, I, kh, kw), 3D conv (kd, kh, kw, I, O) ->
  (O, I, kd, kh, kw); every other leaf is copied as it is. Quantized leaves
  (``quant_weight``, ``scales``, ``biases``) are ``(out, ...)`` in both;
- uint32 words (``quant_weight``) become the int32 tensor with the same bits,
  and go back as uint32.

bfloat16 arrays (ml_dtypes) are read through their bits, so this module
imports no JAX and no ml_dtypes; on the way back to numpy bfloat16 tensors
widen to fp32, which is exact.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

STACKED_KEYS = ("blocks", "res_blocks", "post_upsample_res_blocks")

_TO_TORCH = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_TO_JAX = {2: (1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _leaf_to_torch(name: str, leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        t = leaf
    else:
        arr = np.array(leaf)  # a writable, contiguous copy
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        elif arr.dtype == np.uint32:
            t = torch.from_numpy(arr.view(np.int32))
        else:
            t = torch.from_numpy(arr)
    if name == "weight" and t.dim() in _TO_TORCH:
        t = t.permute(*_TO_TORCH[t.dim()])
    return t.contiguous()


def to_jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A port leaf in the JAX package's layout, still a torch tensor:
    ``weight`` leaves transposed, ``quant_weight`` words viewed as uint32."""
    t = t.detach()
    if name == "weight" and t.dim() in _TO_JAX:
        t = t.permute(*_TO_JAX[t.dim()])
    if name == "quant_weight":
        t = t.contiguous().view(torch.uint32)
    return t.contiguous()


def _leaf_to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    t = to_jax_layout(name, t.cpu())
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.ascontiguousarray(t.numpy())


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _num_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def jax_tree_to_state_dict(tree: dict) -> Dict[str, torch.Tensor]:
    """JAX param pytree (numpy arrays or torch tensors) -> state dict of the
    port's module (CPU tensors unless the tree held others)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: dict, prefix: str) -> None:
        for key, val in node.items():
            path = f"{prefix}{key}"
            if not isinstance(val, dict):
                out[path] = _leaf_to_torch(key, val)
            elif key in STACKED_KEYS:
                for i in range(_num_layers(val)):
                    walk(_layer(val, i), f"{path}.{i}.")
            else:
                walk(val, f"{path}.")

    walk(tree, "")
    return out


def _restack(state: Dict[str, torch.Tensor], leaf_fn: Callable, stack_fn: Callable) -> dict:
    tree: dict = {}
    for path, t in state.items():
        parts = path.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf_fn(parts[-1], t)

    def stack(layers: list):
        if isinstance(layers[0], dict):
            return {k: stack([layer[k] for layer in layers]) for k in layers[0]}
        return stack_fn(layers)

    def restack(node: dict) -> dict:
        for key, val in node.items():
            if not isinstance(val, dict):
                continue
            if key in STACKED_KEYS:
                node[key] = stack([restack(val[str(i)]) for i in range(len(val))])
            else:
                restack(val)
        return node

    return restack(tree)


def state_dict_to_jax_tree(state: Dict[str, torch.Tensor]) -> dict:
    """State dict of a port module -> JAX param pytree of numpy arrays."""
    return _restack(state, _leaf_to_numpy, lambda xs: np.stack(xs, axis=0))


def state_dict_to_jax_layout(state: Dict[str, torch.Tensor]) -> dict:
    """State dict -> JAX param pytree of torch tensors in their stored dtypes
    (bf16 stays bf16, words are uint32): what a native checkpoint holds."""
    return _restack(state, to_jax_layout, lambda xs: torch.stack(xs, dim=0))


def quant_specs(module: nn.Module, state: Dict[str, torch.Tensor]) -> dict:
    """For each ``<name>.quant_weight`` in ``state`` whose ``<name>`` is a
    dense ``Linear`` of ``module``: (bits, group_size, scale dtype), read
    from the shapes as ``use_quant_linears`` takes them."""
    from mlx_video_tpu_torch.ops.linear import Linear
    from mlx_video_tpu_torch.ops.quant import infer_quant_spec

    specs = {}
    for key, words in state.items():
        name = key[: -len(".quant_weight")]
        if not key.endswith(".quant_weight") or not isinstance(module.get_submodule(name), Linear):
            continue
        out_dim, in_dim = module.get_submodule(name).weight.shape
        scales = state[f"{name}.scales"]
        bits, group = infer_quant_spec(name, in_dim, out_dim, tuple(words.shape), tuple(scales.shape))
        specs[name] = (bits, group, scales.dtype)
    return specs


def load_jax_params(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a JAX param pytree into ``module`` (names and shapes must match
    exactly); values are cast to the module's dtypes and device. Linears the
    tree holds quantized become ``QuantLinear``s first."""
    from mlx_video_tpu_torch.ops.quant import use_quant_linears

    state = jax_tree_to_state_dict(tree)
    use_quant_linears(module, quant_specs(module, state))
    module.load_state_dict(state, strict=True)
    return module


def module_to_jax_tree(module: nn.Module) -> dict:
    return state_dict_to_jax_tree(module.state_dict())
