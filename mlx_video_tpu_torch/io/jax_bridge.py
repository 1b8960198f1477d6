"""Weight bridge between the JAX package's param pytrees and the port's modules.

A JAX pytree here is a nested dict of numpy arrays (``jax.tree.map(np.asarray,
params)``), as ``init_ltx_params``, ``init_latent_upsampler`` and
``init_video_decoder`` build it, or of torch tensors in the same layout, as a
native checkpoint reads (io/weights.py). The port's modules keep the same
names, so the mapping is mechanical:

- subtrees named ``blocks``, ``res_blocks`` and ``post_upsample_res_blocks``
  (and ``layers`` of the Gemma-3 tree, by the ``stacked`` argument) are
  stacked along a leading layer axis in JAX and are ``nn.ModuleList``s
  here: layer ``i`` becomes the path component ``.i``. The VAE encoder's
  ``res_blocks`` are the exception: its JAX tree keys them by index
  (``{"0": ..., "1": ...}``) and does not stack them, so they map one to
  one (:func:`encoder_to_jax_tree` for the way back);
- a ``weight`` leaf changes layout: linear (in, out) -> (out, in), 2D conv
  (kh, kw, I, O) -> (O, I, kh, kw), 3D conv (kd, kh, kw, I, O) ->
  (O, I, kd, kh, kw), except a lookup table's (``embed_tokens``, (vocab,
  dim) in both); the W8A8 ``int8_weight`` goes (in, out) -> (out, in) too;
  every other leaf is copied as it is. Quantized leaves (``quant_weight``,
  ``scales``, ``biases``) are ``(out, ...)`` in both, and so is ``int8_scale``;
- uint32 words (``quant_weight``) become the int32 tensor with the same bits,
  and go back as uint32;
- LoRA leaves (``lora_A`` (r, in), ``lora_B`` (out, r), ``lora_scale``) are
  copied as they are: stacked (L, r, in), (L, out, r) and (L,) in the JAX
  tree, per block here;
- the vocoder's 1-D convs are (K, I, O) in JAX and (O, I, K) here, its
  transposed convs (``ups``) (I, O, K) here (:func:`vocoder_state_dict`,
  :func:`vocoder_to_jax_tree`); the audio VAE decoder's JAX tree keeps an
  empty ``attn`` dict in each up stage (:func:`audio_decoder_to_jax_tree`).

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
GEMMA_STACKED_KEYS = ("layers",)  # the Gemma-3 layer stack (models/gemma3.py)
TABLES = ("embed_tokens",)  # 2-D ``weight`` leaves that are lookup tables, not linears

_TO_TORCH = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_TO_JAX = {2: (1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _leaf_to_torch(name: str, leaf, parent: str = "") -> torch.Tensor:
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
    if name == "weight" and t.dim() in _TO_TORCH and parent not in TABLES:
        t = t.permute(*_TO_TORCH[t.dim()])
    if name == "int8_weight" and t.dim() == 2:
        t = t.t()
    return t.contiguous()


def to_jax_layout(name: str, t: torch.Tensor, parent: str = "") -> torch.Tensor:
    """A port leaf in the JAX package's layout, still a torch tensor:
    ``weight`` and ``int8_weight`` leaves transposed (not a table's),
    ``quant_weight`` words viewed as uint32."""
    t = t.detach()
    if name == "weight" and t.dim() in _TO_JAX and parent not in TABLES:
        t = t.permute(*_TO_JAX[t.dim()])
    if name == "int8_weight" and t.dim() == 2:
        t = t.t()
    if name == "quant_weight":
        t = t.contiguous().view(torch.uint32)
    return t.contiguous()


def _leaf_to_numpy(name: str, t: torch.Tensor, parent: str = "") -> np.ndarray:
    t = to_jax_layout(name, t.cpu(), parent)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()  # contiguous already; keeps a 0-d leaf 0-d


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _num_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def jax_tree_to_state_dict(tree: dict, stacked=STACKED_KEYS) -> Dict[str, torch.Tensor]:
    """JAX param pytree (numpy arrays or torch tensors) -> state dict of the
    port's module (CPU tensors unless the tree held others)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: dict, prefix: str, parent: str) -> None:
        for key, val in node.items():
            path = f"{prefix}{key}"
            if not isinstance(val, dict):
                out[path] = _leaf_to_torch(key, val, parent)
            elif key in stacked and not all(k.isdigit() for k in val):
                for i in range(_num_layers(val)):
                    walk(_layer(val, i), f"{path}.{i}.", str(i))
            else:
                walk(val, f"{path}.", key)

    walk(tree, "", "")
    return out


def _restack(state: Dict[str, torch.Tensor], leaf_fn: Callable, stack_fn: Callable,
             stacked=STACKED_KEYS) -> dict:
    tree: dict = {}
    for path, t in state.items():
        parts = path.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf_fn(parts[-1], t, parts[-2] if len(parts) > 1 else "")

    def stack(layers: list):
        if isinstance(layers[0], dict):
            return {k: stack([layer[k] for layer in layers]) for k in layers[0]}
        return stack_fn(layers)

    def restack(node: dict) -> dict:
        for key, val in node.items():
            if not isinstance(val, dict):
                continue
            if key in stacked:
                node[key] = stack([restack(val[str(i)]) for i in range(len(val))])
            else:
                restack(val)
        return node

    return restack(tree)


def state_dict_to_jax_tree(state: Dict[str, torch.Tensor], stacked=STACKED_KEYS) -> dict:
    """State dict of a port module -> JAX param pytree of numpy arrays."""
    return _restack(state, _leaf_to_numpy, lambda xs: np.stack(xs, axis=0), stacked)


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


def load_jax_params(module: nn.Module, tree: dict, stacked=STACKED_KEYS) -> nn.Module:
    """Copy a JAX param pytree into ``module`` (names and shapes must match
    exactly); values are cast to the module's dtypes and device. Linears the
    tree holds quantized become ``QuantLinear``s first (with the W4A8
    ``int8_scale`` if the tree has one), linears it holds in W8A8
    ``Int8Linear``s, and linears it gives LoRA leaves get adapters (lora.py)
    of those shapes."""
    from mlx_video_tpu_torch.lora import attach_lora_leaves
    from mlx_video_tpu_torch.ops.int8 import use_int8_linears
    from mlx_video_tpu_torch.ops.quant import use_quant_linears

    state = jax_tree_to_state_dict(tree, stacked)
    use_quant_linears(module, quant_specs(module, state))
    use_int8_linears(module, state)
    attach_lora_leaves(module, state)
    module.load_state_dict(state, strict=True)
    return module


def module_to_jax_tree(module: nn.Module, stacked=STACKED_KEYS) -> dict:
    return state_dict_to_jax_tree(module.state_dict(), stacked)


def encoder_to_jax_tree(encoder: nn.Module) -> dict:
    """A ``VideoEncoder`` as the JAX ``init_video_encoder`` tree: nothing is
    stacked."""
    return _restack(encoder.state_dict(), _leaf_to_numpy, None, ())


def audio_decoder_to_jax_tree(decoder: nn.Module) -> dict:
    """An ``AudioDecoder`` as the JAX ``init_audio_decoder`` tree: nothing is
    stacked, and every up stage has its ``attn`` dict (empty without
    attention blocks)."""
    tree = _restack(decoder.state_dict(), _leaf_to_numpy, None, ())
    for stage in tree["up"].values():
        stage.setdefault("attn", {})
    return tree


def _vocoder_layout(state: Dict[str, torch.Tensor], transposed: Callable, conv: Callable) -> Dict[str, torch.Tensor]:
    return {path: (transposed(t) if path.startswith("ups.") else conv(t))
            if path.endswith(".weight") and t.dim() == 3 else t for path, t in state.items()}


def vocoder_state_dict(tree: dict) -> Dict[str, torch.Tensor]:
    """The JAX ``init_vocoder`` tree -> a ``Vocoder``'s state dict: (K, I, O)
    -> (O, I, K) for the convs, (I, O, K) for the transposed convs."""
    state = jax_tree_to_state_dict(tree, stacked=())
    return {k: t.contiguous() for k, t in _vocoder_layout(
        state, lambda t: t.permute(1, 2, 0), lambda t: t.permute(2, 1, 0)).items()}


def vocoder_to_jax_tree(vocoder: nn.Module) -> dict:
    """A ``Vocoder`` as the JAX ``init_vocoder`` tree of numpy arrays."""
    state = _vocoder_layout(vocoder.state_dict(), lambda t: t.permute(2, 0, 1), lambda t: t.permute(2, 1, 0))
    return _restack(state, _leaf_to_numpy, None, ())
