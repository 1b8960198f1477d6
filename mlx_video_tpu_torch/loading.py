"""Model-bundle loading: resolve the weight files of a snapshot and build the
components of the distilled video pipeline on one device.

Counterpart of mlx_video_tpu/loading.py for the distilled, video-only path:
the DiT (PyTorch, MLX, MLX pre-quantized or native layout; io/weights.py),
the VAE decoder and the 2x upsampler (io/vae_weights.py). Not ported yet, and
refused with ``NotImplementedError``: the dev pipeline, audio, the VAE
encoder (image/video conditioning), a separate stage-2 transformer, and the
W8A8 / W4A8 execution modes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import torch

from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType
from mlx_video_tpu_torch.io import vae_weights
from mlx_video_tpu_torch.io.safetensors import read_metadata
from mlx_video_tpu_torch.io.weights import load_dit_params, load_native_params
from mlx_video_tpu_torch.models.ltx.upsampler import init_latent_upsampler
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, init_video_decoder
from mlx_video_tpu_torch.ops.quant import quantize_dit_params
from mlx_video_tpu_torch.pipelines.generate import ModelBundle

UNIFIED_FORMAT = "mlx_video_tpu_unified"
UPSAMPLER_FILE = "ltx-2-spatial-upscaler-x2-1.0.safetensors"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to mlx_video_tpu_torch yet (ROADMAP.md queue: {item})")


def resolve_transformer_file(model_path: Path, kind: str, bits_hint: Optional[str] = None) -> Path:
    """ltx-2-19b-{kind}[-bits][-mlx].safetensors, first found."""
    candidates: List[Path] = []
    if bits_hint:
        candidates.append(model_path / f"ltx-2-19b-{kind}-{bits_hint}-mlx.safetensors")
    candidates.append(model_path / f"ltx-2-19b-{kind}-mlx.safetensors")
    candidates.append(model_path / f"ltx-2-19b-{kind}.safetensors")
    for c in candidates:
        if c.exists():
            return c
    raise FileNotFoundError(
        f"Transformer weights not found under {model_path} (tried {[c.name for c in candidates]})"
    )


def resolve_vae_file(model_path: Path, bits_hint: Optional[str] = None) -> Path:
    """``vae/diffusion_pytorch_model.safetensors``, else a single-file
    snapshot (which carries the VAE tensors beside the transformer's), else
    a unified bundle."""
    candidates = [model_path / "vae" / "diffusion_pytorch_model.safetensors"]
    for kind in ("dev", "distilled"):
        if bits_hint:
            candidates.append(model_path / f"ltx-2-19b-{kind}-{bits_hint}-mlx.safetensors")
        candidates.append(model_path / f"ltx-2-19b-{kind}-mlx.safetensors")
        candidates.append(model_path / f"ltx-2-19b-{kind}.safetensors")
    for candidate in candidates:
        if candidate.exists():
            return candidate
    unified = unified_bundle_file(model_path)
    if unified is not None:
        return unified
    raise FileNotFoundError(f"VAE weights not found under {model_path}")


def unified_bundle_file(model_path: Path) -> Optional[Path]:
    """``model.safetensors`` tagged ``format: mlx_video_tpu_unified``, if present."""
    bundle = Path(model_path) / "model.safetensors"
    if not bundle.exists():
        return None
    try:
        meta = read_metadata(bundle)
    except Exception:
        return None
    return bundle if meta.get("format") == UNIFIED_FORMAT else None


def model_config_for(pipeline: str = "distilled", audio: bool = False) -> LTXModelConfig:
    """The 19B video DiT configuration (the pipeline does not change it)."""
    if audio:
        raise _not_ported("The audio-video transformer", "Audio")
    return LTXModelConfig(model_type=LTXModelType.VideoOnly, rope_type=LTXRopeType.SPLIT,
                          double_precision_rope=True)


def bits_hint_for(repo: str) -> Optional[str]:
    """Grid-width hint from a repo or path name ("...-8bit...", "...q4...")."""
    repo_l = str(repo).lower()
    if any(x in repo_l for x in ("8bit", "q8", "int8")):
        return "8bit"
    if any(x in repo_l for x in ("4bit", "q4", "int4")):
        return "4bit"
    return None


def read_quantization_metadata(model_path: Path) -> Optional[Dict]:
    """``quantization.json`` next to the weights, or in the parent directory."""
    for candidate in (Path(model_path), Path(model_path).parent):
        meta = candidate / "quantization.json"
        if meta.exists():
            return json.loads(meta.read_text())
    return None


def load_model_bundle(
    model_path: Path,
    pipeline: str = "distilled",
    audio: bool = False,
    dtype=torch.bfloat16,
    bits_hint: Optional[str] = None,
    stage2_path: Optional[Path] = None,
    load_encoder: bool = False,
    device="cuda",
) -> ModelBundle:
    """Load the distilled video pipeline's components from a snapshot onto
    ``device``: transformer, VAE decoder (its weights over a seeded init, as
    the JAX loader fills its init) and, when the snapshot has it, the
    upsampler."""
    if pipeline != "distilled":
        raise _not_ported(f"The {pipeline!r} pipeline", "Dev pipeline")
    if audio:
        raise _not_ported("Audio generation", "Audio")
    if load_encoder:
        raise _not_ported("The VAE encoder (image and video conditioning)", "Dev pipeline")
    if stage2_path is not None:
        raise _not_ported("A separate stage-2 transformer", "Dev pipeline")
    model_path = Path(model_path)
    device = torch.device(device)
    config = model_config_for(pipeline, audio)

    unified = unified_bundle_file(model_path)
    if unified is not None:
        transformer = load_native_params(unified, config, dtype=dtype, device=device, prefix="transformer.")
    else:
        tf_file = resolve_transformer_file(model_path, pipeline, bits_hint)
        transformer = load_dit_params([tf_file], config, dtype=dtype, device=device)

    generator = torch.Generator(device=device).manual_seed(0)
    dec_cfg = DecoderConfig()
    decoder = init_video_decoder(generator, dec_cfg, device=device, dtype=dtype)
    vae_weights.load_video_decoder_weights(resolve_vae_file(model_path, bits_hint), decoder)

    upsampler = None
    ups_file = model_path / UPSAMPLER_FILE
    if ups_file.exists():
        upsampler = init_latent_upsampler(generator, device=device, dtype=dtype)
        vae_weights.load_upsampler_weights(ups_file, upsampler)

    return ModelBundle(
        transformer=transformer,
        transformer_config=config,
        vae_decoder=decoder,
        vae_decoder_config=dec_cfg,
        upsampler=upsampler,
    )


def quantize_models(
    models: ModelBundle,
    *,
    w8a8: bool = False,
    w4a8: bool = False,
    quantize_bits: Optional[int] = None,
) -> None:
    """Quantize the loaded transformer's dense block linears in place to
    ``quantize_bits`` (group 64, ``core`` scope); linears a snapshot holds
    pre-quantized stay as they are. (The JAX function's ``model_path`` and
    ``repo_hint`` resolve W4A8's bit width, which waits with W4A8.)"""
    if w8a8 and w4a8:
        raise ValueError("--w8a8 and --w4a8 are mutually exclusive")
    if w8a8 or w4a8:
        raise _not_ported("W8A8 / W4A8 execution (ops/int8.py, prepare_w4a8)", "W4A8 and W8A8 execution")
    if quantize_bits:
        quantize_dit_params(models.transformer, bits=quantize_bits)
