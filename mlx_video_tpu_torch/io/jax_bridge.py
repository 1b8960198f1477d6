"""Weight bridge between the JAX package's param pytrees and the port's modules.

A JAX pytree here is a nested dict of numpy arrays (``jax.tree.map(np.asarray,
params)``), as ``init_ltx_params``, ``init_latent_upsampler`` and
``init_video_decoder`` build it. The port's modules keep the same names, so
the mapping is mechanical:

- subtrees named ``blocks``, ``res_blocks`` and ``post_upsample_res_blocks``
  are stacked along a leading layer axis in JAX and are ``nn.ModuleList``s
  here: layer ``i`` becomes the path component ``.i``;
- a ``weight`` leaf changes layout: linear (in, out) -> (out, in), 2D conv
  (kh, kw, I, O) -> (O, I, kh, kw), 3D conv (kd, kh, kw, I, O) ->
  (O, I, kd, kh, kw); every other leaf is copied as it is.

bfloat16 arrays (ml_dtypes) are read through their bits, so this module
imports no JAX and no ml_dtypes; on the way back bfloat16 tensors widen to
fp32 numpy, which is exact.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

STACKED_KEYS = ("blocks", "res_blocks", "post_upsample_res_blocks")

_TO_TORCH = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_TO_JAX = {2: (1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _leaf_to_torch(name: str, arr) -> torch.Tensor:
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if name == "weight" and t.dim() in _TO_TORCH:
        t = t.permute(*_TO_TORCH[t.dim()])
    return t.contiguous()


def _leaf_to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if name == "weight" and t.dim() in _TO_JAX:
        t = t.permute(*_TO_JAX[t.dim()])
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.ascontiguousarray(t.numpy())


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _num_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def jax_tree_to_state_dict(tree: dict) -> Dict[str, torch.Tensor]:
    """JAX param pytree -> state dict of the port's module (CPU tensors)."""
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


def _stack(layers: list):
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return np.stack(layers, axis=0)


def state_dict_to_jax_tree(state: Dict[str, torch.Tensor]) -> dict:
    """State dict of a port module -> JAX param pytree of numpy arrays."""
    tree: dict = {}
    for path, t in state.items():
        parts = path.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _leaf_to_numpy(parts[-1], t)

    def restack(node: dict) -> dict:
        for key, val in node.items():
            if not isinstance(val, dict):
                continue
            if key in STACKED_KEYS:
                node[key] = _stack([restack(val[str(i)]) for i in range(len(val))])
            else:
                restack(val)
        return node

    return restack(tree)


def load_jax_params(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a JAX param pytree into ``module`` (names and shapes must match
    exactly); values are cast to the module's dtypes and device."""
    module.load_state_dict(jax_tree_to_state_dict(tree), strict=True)
    return module


def module_to_jax_tree(module: nn.Module) -> dict:
    return state_dict_to_jax_tree(module.state_dict())
