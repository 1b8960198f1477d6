"""Weight loading for the Gemma-3 text encoder and the LTX connectors.

Counterpart of mlx_video_tpu/io/text_encoder_weights.py:

- :func:`load_gemma_weights`: the Gemma shard set of a snapshot (the same
  file selection), keys with or without a ``language_model.`` /
  ``model.language_model.`` / ``model.`` prefix; MLX-quantized linears (a
  uint32 ``weight`` with ``scales`` and ``biases``) load as ``QuantLinear``s
  and a quantized embedding is dequantized at load;
- :func:`load_connector_weights`: the feature extractor and both connectors
  from whichever of the four layouts the snapshot has, in the JAX loader's
  order and with its stopping rule.

Checkpoints hold linear weights in PyTorch's ``(out, in)`` layout, the
port's, so nothing is transposed (the JAX loaders transpose to ``(in, out)``)
and nothing is stacked. Floating tensors take the model's dtype, except the
quantized ``scales`` and ``biases``. The model is built on the ``meta``
device and each tensor read from the memory-mapped file straight to its
device, so the 12B is never held twice.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import torch
from torch import nn

from mlx_video_tpu_torch.io.safetensors import SafetensorsReader
from mlx_video_tpu_torch.models.gemma3 import Gemma3Model, Gemma3TextConfig
from mlx_video_tpu_torch.ops.quant import dequantize_affine, infer_quant_spec, use_quant_linears

_GEMMA_LIN = {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"}


def _gemma_weight_files(path: Path):
    """The shard set (the JAX loader's selection)."""
    if (path / "diffusion_pytorch_model.safetensors.index.json").exists():
        return sorted(path.glob("diffusion_pytorch_model-*.safetensors"))
    if (path / "model.safetensors.index.json").exists():
        return sorted(path.glob("model-*.safetensors"))
    if (path / "diffusion_pytorch_model.safetensors").exists():
        return [path / "diffusion_pytorch_model.safetensors"]
    if (path / "model.safetensors").exists():
        return [path / "model.safetensors"]
    return sorted(path.glob("*.safetensors"))


def _gemma_name(key: str):
    """Checkpoint key -> the port's Gemma state name (None for keys outside
    the text stack, such as a vision tower's)."""
    k = key
    for prefix in ("language_model.", "model.language_model."):
        if k.startswith(prefix):
            k = k[len(prefix):]
    if k.startswith("model."):
        k = k[len("model."):]
    parts = k.split(".")
    if parts[0] == "embed_tokens" and parts[-1] in ("weight", "scales", "biases"):
        return f"embed_tokens.{parts[-1]}"
    if parts[0] == "norm" and parts[-1] == "weight":
        return "norm.weight"
    if parts[0] == "layers":
        return k
    return None


def load_gemma_weights(path: Path, config: Gemma3TextConfig, dtype=torch.bfloat16, device="cuda") -> Gemma3Model:
    """The Gemma-3 text stack of a snapshot directory on ``device``. Every
    layer must be in the files (a missing one raises, as the JAX loader's
    layer count check)."""
    files = _gemma_weight_files(Path(path))
    if not files:
        raise FileNotFoundError(f"No Gemma safetensors shards under {path}")
    readers = [SafetensorsReader(f) for f in files]
    try:
        sources = {}
        for reader in readers:
            for key in reader.keys():
                name = _gemma_name(key)
                if name is not None:
                    sources[name] = (reader, key)
        model = Gemma3Model(config, device="meta", dtype=dtype)
        per_layer: Dict[str, int] = {}
        for name in sources:
            if name.startswith("layers."):
                sub = name.split(".", 2)[2]
                per_layer[sub] = per_layer.get(sub, 0) + 1
        for sub, n in per_layer.items():
            if n != config.num_hidden_layers:
                raise ValueError(f"Gemma leaf {sub} has {n}/{config.num_hidden_layers} layers")

        specs = {}
        for name, (reader, key) in sources.items():
            base, _, leaf = name.rpartition(".")
            if (name.startswith("layers.") and leaf == "weight" and base.rsplit(".", 1)[-1] in _GEMMA_LIN
                    and reader.dtype_name(key) == "U32"):
                out_dim, in_dim = model.get_submodule(base).weight.shape
                sr, sk = sources[f"{base}.scales"]
                bits, group = infer_quant_spec(base, in_dim, out_dim, reader.shape(key), sr.shape(sk))
                specs[base] = (bits, group, sr.dtype(sk))
        use_quant_linears(model, specs)
        state = {}
        for name in model.state_dict():
            base, _, leaf = name.rpartition(".")
            src = sources.get(f"{base}.weight" if leaf == "quant_weight" else name)
            if src is None:
                raise ValueError(f"Missing Gemma tensor {name} under {path}")
            t = src[0].get(src[1], device)
            if name == "embed_tokens.weight" and src[0].dtype_name(src[1]) == "U32":
                (sr, sk), (br, bk) = sources["embed_tokens.scales"], sources["embed_tokens.biases"]
                t = dequantize_affine(t, sr.get(sk, device), br.get(bk, device), dtype=dtype,
                                      in_dim=config.hidden_size)
            if t.is_floating_point() and leaf not in ("scales", "biases"):
                t = t.to(dtype)
            state[name] = t
        model.load_state_dict(state, strict=True, assign=True)
        return model
    finally:
        for reader in readers:
            reader.close()


_CONNECTOR_PREFIXES = {
    "video_embeddings_connector": (
        "model.diffusion_model.video_embeddings_connector.",
        "connector.video_embeddings_connector.",
        "video_connector.",
    ),
    "audio_embeddings_connector": (
        "model.diffusion_model.audio_embeddings_connector.",
        "connector.audio_embeddings_connector.",
        "audio_connector.",
    ),
}
_FEATURE_KEYS = ("text_embedding_projection.aggregate_embed.weight", "text_proj_in.weight")


def _connector_files(model_path: Path):
    """Candidate files in priority order (the JAX loader's)."""
    candidates = [
        model_path / "model.safetensors",
        model_path / "connectors" / "ltx_text_connectors.safetensors",
        model_path / "connectors" / "diffusion_pytorch_model.safetensors",
    ]
    candidates += sorted(model_path.glob("ltx-2-19*.safetensors"))
    return [c for c in candidates if c.exists()]


def _map_connector_key(key: str):
    """Checkpoint key past its prefix -> the connector's state name."""
    k = key.replace(".ff.net.0.proj.", ".ff.proj_in.")
    k = k.replace(".ff.net.2.", ".ff.proj_out.")
    k = k.replace(".to_out.0.", ".to_out.")
    parts = k.split(".")
    if parts[0] == "learnable_registers":
        return "learnable_registers"
    if parts[0] == "transformer_1d_blocks":
        return k
    return None


@torch.no_grad()
def load_connector_weights(model: nn.Module, model_path: Path) -> int:
    """Fill the feature extractor and both connectors of a
    ``TextEncoderModel`` in place, in its dtype and on its device, from
    whichever layout exists; returns the number of tensors loaded."""
    params = dict(model.named_parameters())
    loaded = 0
    for file in _connector_files(Path(model_path)):
        with SafetensorsReader(file) as r:
            keys = set(r.keys())
            hit = False

            def put(name: str, key: str) -> None:
                target = params.get(name)
                if target is not None:  # JAX adds a leaf no layer reads
                    target.copy_(r.get(key, target.device).to(target.dtype))

            for fk in _FEATURE_KEYS:
                if fk in keys:
                    put("feature_extractor.aggregate_embed.weight", fk)
                    loaded += 1
                    hit = True
            for target, prefixes in _CONNECTOR_PREFIXES.items():
                for key in keys:
                    for prefix in prefixes:
                        if not key.startswith(prefix):
                            continue
                        mapped = _map_connector_key(key[len(prefix):])
                        if mapped is None:
                            continue
                        put(f"{target}.{mapped}", key)
                        loaded += 1
                        hit = True
            if hit and loaded > 2:
                break
    return loaded
