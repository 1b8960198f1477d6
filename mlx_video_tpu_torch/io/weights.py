"""Checkpoint loading for the DiT: key sanitization and the state dict.

Counterpart of mlx_video_tpu/io/weights.py. Checkpoints hold linear weights
in PyTorch's ``(out, in)`` layout, which is the port's, so nothing is
transposed here (the JAX loader transposes to ``(in, out)``); and the port
keeps one module per block, so nothing is stacked.

The loader builds the model as a skeleton on the ``meta`` device, reads each
tensor out of the memory-mapped file straight to its device, and assigns it
(``load_state_dict(..., assign=True)``): the model is never held twice.

Layouts read by :func:`load_dit_params`:
- PyTorch keys ``model.diffusion_model.*`` (sanitized as the MLX reference
  does) and sanitized MLX keys;
- MLX pre-quantized linears: a uint32 ``<name>.weight`` with its
  ``<name>.scales`` and ``<name>.biases``, loaded as a ``QuantLinear``;
- the native ``format: mlx_video_tpu`` files of :func:`save_dit_params` (the
  JAX package's layout: stacked blocks, ``(in, out)`` linears), through the
  JAX bridge, with their W8A8 ``int8_weight``/``int8_scale`` leaves (the
  files ``convert --w8a8`` writes) as ``Int8Linear``s.

Floating tensors take the model dtype, except the quantized ``scales`` and
``biases`` and the int8 ``int8_scale``, which keep theirs. (The JAX loader keeps bf16 and fp16 leaves as
stored; the port's modules hold one dtype.)
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import torch

from mlx_video_tpu_torch.config import LTXModelConfig
from mlx_video_tpu_torch.io.jax_bridge import jax_tree_to_state_dict, quant_specs, state_dict_to_jax_layout
from mlx_video_tpu_torch.io.safetensors import SafetensorsReader, read_metadata, save_safetensors
from mlx_video_tpu_torch.models.ltx.model import LTXModel
from mlx_video_tpu_torch.ops.int8 import use_int8_linears
from mlx_video_tpu_torch.ops.quant import infer_quant_spec, use_quant_linears

PT_PREFIX = "model.diffusion_model."
NATIVE_FORMAT = "mlx_video_tpu"

# Sanitized names that live at the model top level (everything else belongs
# to transformer_blocks.{i}); the audio ones carry an ``audio_`` prefix.
_VIDEO_TOP = {"patchify_proj", "adaln_single", "caption_projection", "scale_shift_table", "proj_out"}
# The cross-modal adaLNs of an AudioVideo checkpoint -> their names under ``av``
_AV_ADALN = {
    "av_ca_video_scale_shift_adaln_single": "av_ca_video_scale_shift_adaln",
    "av_ca_audio_scale_shift_adaln_single": "av_ca_audio_scale_shift_adaln",
    "av_ca_a2v_gate_adaln_single": "av_ca_a2v_gate_adaln",
    "av_ca_v2a_gate_adaln_single": "av_ca_v2a_gate_adaln",
}
_QUANT_AUX = ("scales", "biases")
_KEEP_DTYPE = (*_QUANT_AUX, "int8_scale")  # fp32 scales of the quantized and int8 linears


def sanitize_pt_key(key: str) -> Optional[str]:
    """PyTorch checkpoint key -> MLX-layout sanitized key; None for keys
    outside the DiT."""
    if not key.startswith(PT_PREFIX):
        return None
    if "audio_embeddings_connector" in key or "video_embeddings_connector" in key:
        return None
    k = key[len(PT_PREFIX) :]
    for old, new in (
        (".to_out.0.", ".to_out."),
        (".ff.net.0.proj.", ".ff.proj_in."),
        (".ff.net.2.", ".ff.proj_out."),
        (".audio_ff.net.0.proj.", ".audio_ff.proj_in."),
        (".audio_ff.net.2.", ".audio_ff.proj_out."),
        (".linear_1.", ".linear1."),
        (".linear_2.", ".linear2."),
    ):
        k = k.replace(old, new)
    return k


def dit_tree_path(sanitized_key: str) -> Optional[str]:
    """Sanitized key -> name in the port's DiT state dict
    (``transformer_blocks.{i}.*`` -> ``blocks.{i}.*``, video top-level
    names -> ``video.*``, ``audio_`` top-level names -> ``audio.*``, the
    cross-modal adaLNs -> ``av.*``); None for keys no model type has a place
    for (parameter-free norms such as ``audio_norm_out``). A loader skips the
    names its model type lacks: a VideoOnly or AudioOnly model reads its part
    of an AudioVideo file."""
    parts = sanitized_key.split(".")
    name = parts[0]
    if name == "transformer_blocks":
        return ".".join(["blocks"] + parts[1:])
    if name in _AV_ADALN:
        return ".".join(["av", _AV_ADALN[name]] + parts[1:])
    if name.startswith("audio_"):
        sub = name[len("audio_"):]
        return ".".join(["audio", sub] + parts[1:]) if sub in _VIDEO_TOP else None
    if name in _VIDEO_TOP:
        return "video." + sanitized_key
    return None


def _missing_error(missing) -> ValueError:
    return ValueError(f"Missing {len(missing)} parameters after load (sample: {sorted(missing)[:20]}).")


def _assign_state(model: LTXModel, state: Dict[str, torch.Tensor], dtype) -> LTXModel:
    """Cast floating leaves (not the quantized scales/biases) to ``dtype``,
    check every name and shape of the skeleton, and assign."""
    expected = model.state_dict()
    missing = [name for name in expected if name not in state]
    if missing:
        raise _missing_error(missing)
    for name, t in state.items():
        if name not in expected:
            continue
        if tuple(t.shape) != tuple(expected[name].shape):
            raise ValueError(
                f"Shape mismatch for {name}: checkpoint {tuple(t.shape)} vs expected {tuple(expected[name].shape)}"
            )
        if t.is_floating_point() and name.rsplit(".", 1)[-1] not in _KEEP_DTYPE:
            state[name] = t.to(dtype)
    model.load_state_dict({k: state[k] for k in expected}, strict=True, assign=True)
    return model


def load_dit_params(
    paths: Union[str, Path, Sequence[Union[str, Path]]],
    config: LTXModelConfig,
    dtype=torch.bfloat16,
    device="cuda",
) -> LTXModel:
    """Build the DiT of ``config``'s model type on ``device`` (default the
    card, as ``load_model_bundle``) from safetensors shard(s).

    Every parameter of the model must be in the files (the strict check of
    the JAX loader); a missing one raises with a sample of the names. Tensors
    the model has no place for are skipped, so a VideoOnly or AudioOnly model
    loads from an AudioVideo file (the JAX loader's ``strict=False`` load).
    """
    paths = [paths] if isinstance(paths, (str, Path)) else list(paths)
    if len(paths) == 1 and read_metadata(paths[0]).get("format") == NATIVE_FORMAT:
        return load_native_params(paths[0], config, dtype=dtype, device=device)

    model = LTXModel(config, device="meta", dtype=dtype)
    expected = model.state_dict()
    readers = [SafetensorsReader(p) for p in paths]
    try:
        sources = {}  # state name -> (reader, checkpoint key)
        for reader in readers:
            for raw in reader.keys():
                sani = sanitize_pt_key(raw) if raw.startswith(PT_PREFIX) else raw
                name = None if sani is None else dit_tree_path(sani)
                if name is None:
                    continue
                base, _, leaf = name.rpartition(".")
                if leaf == "weight" and name in expected and reader.dtype_name(raw) == "U32":
                    name = f"{base}.quant_weight"
                elif name not in expected and not (leaf in _QUANT_AUX and f"{base}.weight" in expected):
                    continue
                sources[name] = (reader, raw)

        specs, missing, incomplete = {}, [], set()
        for name in [n for n in sources if n.endswith(".quant_weight")]:
            base = name[: -len(".quant_weight")]
            aux = [f"{base}.{leaf}" for leaf in _QUANT_AUX]
            if any(a not in sources for a in aux):
                missing += [a for a in aux if a not in sources]
                incomplete.add(base)
                continue
            out_dim, in_dim = expected[f"{base}.weight"].shape
            (pr, pk), (sr, sk) = sources[name], sources[aux[0]]
            bits, group = infer_quant_spec(base, in_dim, out_dim, pr.shape(pk), sr.shape(sk))
            specs[base] = (bits, group, sr.dtype(sk))
        use_quant_linears(model, specs)
        missing += [n for n in model.state_dict() if n not in sources and n.rpartition(".")[0] not in incomplete]
        if missing:
            raise _missing_error(missing)

        state = {}
        for name in model.state_dict():
            reader, raw = sources[name]
            state[name] = reader.get(raw, device)
        return _assign_state(model, state, dtype)
    finally:
        for reader in readers:
            reader.close()


def _unflatten(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        parts = path.split(".")
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = leaf
    return tree


def _flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{'a': {'b': t}} -> {'a.b': t}, keys sorted at every level as JAX
    flattens a dict, so the file's tensor order is the JAX writer's."""
    flat = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            flat.update(_flatten(val, f"{prefix}{key}."))
        else:
            flat[prefix + key] = val
    return flat


def native_tensors(model: LTXModel) -> Dict[str, torch.Tensor]:
    """The model's tensors in the JAX package's native layout (stacked
    blocks, ``(in, out)`` linears, stored dtypes, uint32 words) under their
    flattened tree names, in the JAX writer's order; on the model's device."""
    return _flatten(state_dict_to_jax_layout(model.state_dict()))


def save_dit_params(path: Union[str, Path], model: LTXModel, metadata: Optional[dict] = None) -> None:
    """Save the model in the native layout (:func:`native_tensors`); the file
    is byte for byte what the JAX ``save_dit_params`` writes for the same
    parameters."""
    save_dit_state(path, model.state_dict(), metadata)


def save_dit_state(path: Union[str, Path], state: Dict[str, torch.Tensor], metadata: Optional[dict] = None) -> None:
    """:func:`save_dit_params` of a DiT's whole state dict."""
    save_safetensors(path, _flatten(state_dict_to_jax_layout(state)),
                     metadata={"format": NATIVE_FORMAT, **(metadata or {})})


def load_native_params(
    path: Union[str, Path], config: LTXModelConfig, dtype=torch.bfloat16, device="cuda", prefix: str = ""
) -> LTXModel:
    """Load a native-layout file (:func:`save_dit_params`, or the JAX
    package's) into the DiT of ``config``'s model type on ``device`` (its
    part of the file). With ``prefix``, read only that subset
    (``"transformer."`` of a unified ``model.safetensors``)."""
    with SafetensorsReader(path) as reader:
        flat = {k[len(prefix) :]: reader.get(k, device) for k in reader.keys() if k.startswith(prefix)}
    model = LTXModel(config, device="meta", dtype=dtype)
    modules = dict(model.named_modules())
    state = {k: t for k, t in jax_tree_to_state_dict(_unflatten(flat)).items() if k.rpartition(".")[0] in modules}
    use_quant_linears(model, quant_specs(model, state))
    use_int8_linears(model, state)
    return _assign_state(model, state, dtype)
