"""Checkpoint conversion: a PyTorch-layout LTX-2 DiT checkpoint -> the native
safetensors file, optionally LoRA-merged and quantized, and the unified
``model.safetensors`` bundle.

Counterpart of mlx_video_tpu/convert.py (``python -m
mlx_video_tpu_torch.convert``, the same flags plus ``--device``). It writes
what the JAX converter writes: the native file of io/weights.py
(``save_dit_params``: the JAX layout, stacked blocks), ``quantization.json``
beside it and the same ``quantization`` header entry when quantizing
(``--quantize-bits`` 2/4/8 into QuantLinears, or ``--w8a8`` into
Int8Linears), the per-linear report under JAX tree paths with JAX dtype
names, and the unified bundle with its ``transformer.``, ``vae_decoder.``,
``vae_encoder.``, ``audio_vae.`` and ``vocoder.`` prefixes. Source tensors
pass into the bundle in their stored dtypes.

The DiT is loaded on ``--device`` (default the card; without CUDA the CLI
exits, ``--device cpu`` runs on the CPU), merged there, and quantized in
place one linear at a time, so the peak is the dense model plus one layer
(and the merged linears with ``--lora``). Differences from the JAX
converter: the ``--w8a8``/``--quantize-bits`` refusal comes before the load;
the source must hold every tensor of the model (the port's loader is
strict); every floating tensor takes ``--dtype`` (the JAX loader keeps bf16
and fp16 source tensors as stored).

    python -m mlx_video_tpu_torch.convert -i SRC.safetensors -o OUT/ltx-2-19b-distilled.safetensors \\
        --model-type video --quantize --report --unified --model-path SNAPSHOT
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import torch

from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType
from mlx_video_tpu_torch.io.jax_bridge import state_dict_to_jax_layout
from mlx_video_tpu_torch.io.safetensors import SafetensorsReader, save_safetensors
from mlx_video_tpu_torch.io.weights import load_dit_params, native_tensors, save_dit_params
from mlx_video_tpu_torch.loading import UNIFIED_FORMAT, resolve_vae_file
from mlx_video_tpu_torch.lora import LoraSpec, merge_lora_into_params
from mlx_video_tpu_torch.models.ltx.model import LTXModel
from mlx_video_tpu_torch.ops.int8 import quantize_params_w8a8
from mlx_video_tpu_torch.ops.quant import quantize_dit_params


def _jax_tree(model: LTXModel) -> dict:
    """The model as the JAX parameter tree, on the ``meta`` device: the
    paths, dtypes and stacked shapes of the native file, no data."""
    return state_dict_to_jax_layout({k: v.to("meta") for k, v in model.state_dict().items()})


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def quantization_report(model: LTXModel) -> List[str]:
    """One line a linear of the JAX tree (a block linear's line covers its
    stacked layers): ``path: quantized uint32``, ``path: w8a8 int8`` or
    ``path: dense <dtype>``, as the JAX report."""
    lines = []

    def walk(node, path):
        if isinstance(node, dict):
            if "quant_weight" in node:
                lines.append(f"{path}: quantized {_dtype_name(node['quant_weight'])}")
            elif "int8_weight" in node:
                lines.append(f"{path}: w8a8 int8")
            elif "weight" in node and node["weight"].dim() >= 2:
                lines.append(f"{path}: dense {_dtype_name(node['weight'])}")
            else:
                for k in sorted(node):
                    walk(node[k], f"{path}.{k}" if path else k)

    walk(_jax_tree(model), "")
    return lines


def _write_quantization_json(output_path: Path, meta: dict) -> None:
    with open(output_path.parent / "quantization.json", "w") as f:
        json.dump(meta, f, indent=2)


def convert_transformer(
    input_paths: List[Path],
    output_path: Path,
    config: Optional[LTXModelConfig] = None,
    dtype=torch.bfloat16,
    quantize_bits: Optional[int] = None,
    quantize_group_size: int = 64,
    quantize_scope: str = "core",
    w8a8: bool = False,
    lora_paths: Optional[List[str]] = None,
    lora_strength: float = 1.0,
    report: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> LTXModel:
    """Load the DiT of ``config`` (default AudioVideo) from ``input_paths`` on
    ``device``, merge ``lora_paths`` at ``lora_strength``, quantize it
    (``quantize_bits`` in groups of ``quantize_group_size`` over
    ``quantize_scope``, or ``w8a8``), print the report when ``report``, and
    write it to ``output_path``; returns the model."""
    if w8a8 and quantize_bits:
        raise ValueError(
            "--w8a8 (int8 execution weights) and --quantize-bits (MLX affine "
            "storage format) are mutually exclusive; pick one."
        )
    config = config or LTXModelConfig(model_type=LTXModelType.AudioVideo)
    model = load_dit_params(input_paths, config, dtype=dtype, device=device)
    if lora_paths:
        model = merge_lora_into_params(model, [LoraSpec(Path(p), lora_strength) for p in lora_paths], verbose=True)

    dtype_name = "bf16" if dtype == torch.bfloat16 else "f32"
    meta = {}
    if w8a8:
        quantize_params_w8a8(model)
        meta = {"mode": "w8a8-int8", "predicate": "core", "dtype": dtype_name}
        _write_quantization_json(output_path, meta)
    if quantize_bits:
        quantize_dit_params(model, group_size=quantize_group_size, bits=quantize_bits, scope=quantize_scope)
        meta = {
            "bits": quantize_bits,
            "group_size": quantize_group_size,
            "mode": "affine",
            "predicate": quantize_scope,
            "dtype": dtype_name,
        }
        _write_quantization_json(output_path, meta)

    if report:
        for line in quantization_report(model):
            print(" ", line)

    save_dit_params(output_path, model, metadata={"quantization": json.dumps(meta)} if meta else None)
    print(f"Saved transformer to {output_path}")
    return model


def _stored(reader: SafetensorsReader, key: str) -> torch.Tensor:
    """A source tensor in its stored dtype (U32 words as uint32)."""
    t = reader.get(key)
    return t.view(torch.uint32) if reader.dtype_name(key) == "U32" else t


def build_unified_bundle(
    output_path: Path,
    transformer: LTXModel,
    model_path: Optional[Path] = None,
    include_audio: bool = True,
) -> int:
    """Write one ``model.safetensors`` with prefixed subsets: ``transformer.*``
    (the native layout), and from ``model_path``'s snapshot ``vae_decoder.*``
    and ``vae_encoder.*`` (the VAE file's ``decoder.``/``encoder.`` tensors;
    ``per_channel_statistics.*`` in both), with ``include_audio``
    ``audio_vae.*`` and ``vocoder.*``, each as stored. Returns the tensor
    count."""
    tensors: Dict[str, torch.Tensor] = {
        f"transformer.{k}": v for k, v in native_tensors(transformer).items()
    }

    def copy_subset(src: Path, out_prefix: str, strip_prefixes: Tuple[str, ...]):
        with SafetensorsReader(src) as r:
            for key in r.keys():
                k = key
                for sp in strip_prefixes:
                    if k.startswith(sp):
                        k = k[len(sp):]
                        break
                tensors[out_prefix + k] = _stored(r, key)

    if model_path is not None:
        model_path = Path(model_path)
        with SafetensorsReader(resolve_vae_file(model_path)) as r:
            for key in r.keys():
                k = key[len("vae."):] if key.startswith("vae.") else key
                if k.startswith("decoder."):
                    tensors["vae_decoder." + k[len("decoder."):]] = _stored(r, key)
                elif k.startswith("encoder."):
                    tensors["vae_encoder." + k[len("encoder."):]] = _stored(r, key)
                elif k.startswith("per_channel_statistics."):
                    # the statistics feed both the encoder's and the decoder's loaders
                    tensors["vae_decoder." + k] = _stored(r, key)
                    tensors["vae_encoder." + k] = _stored(r, key)

        if include_audio:
            audio_file = model_path / "audio_vae" / "diffusion_pytorch_model.safetensors"
            if audio_file.exists():
                copy_subset(audio_file, "audio_vae.", ("audio_vae.",))
            voc_file = model_path / "vocoder" / "diffusion_pytorch_model.safetensors"
            if voc_file.exists():
                copy_subset(voc_file, "vocoder.", ("vocoder.",))

    save_safetensors(output_path, tensors, metadata={"format": UNIFIED_FORMAT})
    print(f"Saved unified bundle ({len(tensors)} tensors) to {output_path}")
    return len(tensors)


def build_parser() -> argparse.ArgumentParser:
    """The JAX converter's flags, plus ``--device``."""
    parser = argparse.ArgumentParser(description="Convert LTX-2 checkpoints to the native format (PyTorch)")
    parser.add_argument("--input", "-i", "--hf-path", required=True, nargs="+",
                        dest="input", help="Input safetensors file(s)")
    parser.add_argument("--output", "-o", "--mlx-path", required=True, dest="output",
                        help="Output safetensors path")
    parser.add_argument("--model-type", default="av", choices=["av", "video", "audio"])
    parser.add_argument("--pipeline", default=None, choices=["dev", "distilled"],
                        help="Informational; recorded in metadata")
    parser.add_argument("--config", default=None,
                        help="JSON file with LTXModelConfig fields (default: 19B geometry)")
    parser.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    parser.add_argument("--quantize", action="store_true",
                        help="Quantize with the default 4 bits (or --q-bits)")
    parser.add_argument("--quantize-bits", "-q", "--q-bits", type=int, default=None,
                        choices=[2, 4, 8], dest="quantize_bits", help="Quantize to N bits")
    parser.add_argument("--quantize-group-size", "--q-group-size", type=int, default=64,
                        dest="quantize_group_size")
    parser.add_argument("--w8a8", action="store_true",
                        help="Export W8A8 int8 execution weights (native format; "
                             "int8 x int8 -> int32 MXU matmuls at load, ops/int8.py)")
    parser.add_argument("--quantize-scope", "--q-mode", default="core",
                        choices=["attn1", "core", "all"], dest="quantize_scope")
    parser.add_argument("--lora", action="append", default=[], help="LoRA file(s) to pre-merge")
    parser.add_argument("--lora-strength", type=float, default=1.0)
    parser.add_argument("--report", "--report-layers", action="store_true", dest="report",
                        help="Print per-layer report")
    parser.add_argument("--unified", action="store_true",
                        help="Also emit a unified model.safetensors bundle")
    parser.add_argument("--model-path", default=None,
                        help="Snapshot dir with VAE/audio/vocoder files for --unified")
    parser.add_argument("--no-audio", action="store_true",
                        help="Exclude audio components from the unified bundle")
    parser.add_argument("--device", default="cuda",
                        help="torch device to convert on (default cuda; exits when CUDA is absent)")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.quantize and args.quantize_bits is None:
        args.quantize_bits = 4
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("convert: --device cuda but CUDA is not available (pass --device cpu to run on the CPU)")

    model_type = {
        "av": LTXModelType.AudioVideo,
        "video": LTXModelType.VideoOnly,
        "audio": LTXModelType.AudioOnly,
    }[args.model_type]
    if args.config:
        cfg_dict = json.loads(Path(args.config).read_text())
        cfg_dict["model_type"] = model_type.value
        config = LTXModelConfig.from_dict(cfg_dict)
    else:
        config = LTXModelConfig(model_type=model_type)
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    model = convert_transformer(
        [Path(p) for p in args.input],
        out,
        config=config,
        dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
        quantize_bits=args.quantize_bits,
        quantize_group_size=args.quantize_group_size,
        quantize_scope=args.quantize_scope,
        w8a8=args.w8a8,
        lora_paths=args.lora,
        lora_strength=args.lora_strength,
        report=args.report,
        device=device,
    )
    if args.unified:
        build_unified_bundle(
            out.parent / "model.safetensors",
            model,
            model_path=Path(args.model_path) if args.model_path else None,
            include_audio=not args.no_audio,
        )


if __name__ == "__main__":
    main()
