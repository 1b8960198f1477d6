"""Model-bundle loading: resolve the weight files of a snapshot and build the
components of a video pipeline (distilled, keyframe, IC-LoRA or dev) on one
device.

Counterpart of mlx_video_tpu/loading.py for the video-only paths: the DiT of
the pipeline's kind (PyTorch, MLX, MLX pre-quantized or native layout;
io/weights.py), a second DiT for stage 2 from another snapshot, the VAE
decoder, the VAE encoder when conditionings need it, and the 2x upsampler
when the snapshot has it (io/vae_weights.py). :func:`quantize_models`
applies the quantized execution modes (4/8-bit storage on K2, W8A8, W4A8).
Not ported yet, and refused with ``NotImplementedError``: audio.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Union

import torch

from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType, VideoVAEConfig
from mlx_video_tpu_torch.io import vae_weights
from mlx_video_tpu_torch.io.safetensors import read_metadata
from mlx_video_tpu_torch.io.weights import load_dit_params, load_native_params
from mlx_video_tpu_torch.models.ltx.upsampler import init_latent_upsampler
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, init_video_decoder
from mlx_video_tpu_torch.models.ltx.video_vae.encoder import init_video_encoder
from mlx_video_tpu_torch.ops.int8 import quantize_params_w8a8
from mlx_video_tpu_torch.ops.linear import QuantLinear
from mlx_video_tpu_torch.ops.quant import prepare_w4a8, quantize_dit_params
from mlx_video_tpu_torch.pipelines.generate import ModelBundle, PipelineType

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
    pipeline: Union[PipelineType, str] = PipelineType.DISTILLED,
    audio: bool = False,
    dtype=torch.bfloat16,
    bits_hint: Optional[str] = None,
    stage2_path: Optional[Path] = None,
    load_encoder: bool = False,
    device="cuda",
) -> ModelBundle:
    """Load a video pipeline's components from a snapshot onto ``device``:
    the transformer of the pipeline's kind (``ltx-2-19b-dev*`` for the dev
    pipeline, ``-distilled*`` otherwise), with ``stage2_path`` a second one
    of the same kind from that snapshot for stage 2, the VAE decoder, with
    ``load_encoder`` the VAE encoder (from the same VAE file), and, when the
    snapshot has it, the upsampler. The VAE parts are loaded over a seeded
    init, as the JAX loader fills its init."""
    pipeline = PipelineType(pipeline)
    if audio:
        raise _not_ported("Audio generation", "Audio")
    model_path = Path(model_path)
    device = torch.device(device)
    config = model_config_for(pipeline.value, audio)
    kind = "dev" if pipeline == PipelineType.DEV else "distilled"

    unified = unified_bundle_file(model_path)
    if unified is not None:
        transformer = load_native_params(unified, config, dtype=dtype, device=device, prefix="transformer.")
    else:
        tf_file = resolve_transformer_file(model_path, kind, bits_hint)
        transformer = load_dit_params([tf_file], config, dtype=dtype, device=device)
    stage2 = None
    if stage2_path is not None:
        stage2 = load_dit_params([resolve_transformer_file(Path(stage2_path), kind, bits_hint)], config,
                                 dtype=dtype, device=device)

    generator = torch.Generator(device=device).manual_seed(0)
    vae_file = resolve_vae_file(model_path, bits_hint)
    dec_cfg = DecoderConfig()
    decoder = init_video_decoder(generator, dec_cfg, device=device, dtype=dtype)
    vae_weights.load_video_decoder_weights(vae_file, decoder)

    encoder = enc_cfg = None
    if load_encoder:
        enc_cfg = VideoVAEConfig()
        encoder = init_video_encoder(generator, enc_cfg, device=device, dtype=dtype)
        vae_weights.load_video_encoder_weights(vae_file, encoder)

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
        vae_encoder=encoder,
        vae_encoder_config=enc_cfg,
        stage2_transformer=stage2,
    )


def quantize_models(
    models: ModelBundle,
    model_path: Optional[Path] = None,
    *,
    w8a8: bool = False,
    w4a8: bool = False,
    quantize_bits: Optional[int] = None,
    repo_hint: str = "",
) -> None:
    """Apply the quantized execution mode to the loaded transformers, in
    place (the JAX function of the same name):

    - ``quantize_bits``: quantize the stage-1 transformer's dense block
      linears (group 64, ``core`` scope), as the JAX function does; linears a
      snapshot holds pre-quantized stay as they are;
    - ``w8a8``: the dense block linears of both transformers become
      ``Int8Linear``s;
    - ``w4a8``: quantize each transformer first if it holds no quantized
      linear, then give every quantized linear its int8 scale
      (``prepare_w4a8``). The STORED
      grid width comes from, in order: ``quantize_bits`` > ``quantization.json``
      next to the weights (``model_path``) > a hint in ``repo_hint``'s name >
      4; assuming 4 bits on an 8-bit snapshot would mis-scale every product.

    ``w8a8`` and ``w4a8`` together, or ``quantize_bits`` against the stored
    width of ``quantization.json``, raise ``ValueError``."""
    if w8a8 and w4a8:
        raise ValueError("--w8a8 and --w4a8 are mutually exclusive")
    transformers = [m for m in (models.transformer, models.stage2_transformer) if m is not None]
    if quantize_bits:
        quantize_dit_params(models.transformer, bits=quantize_bits)
    if w8a8:
        for model in transformers:
            quantize_params_w8a8(model)
    if w4a8:
        qmeta = (read_quantization_metadata(model_path) if model_path is not None else None) or {}
        bits = quantize_bits or qmeta.get("bits") or {"8bit": 8, "4bit": 4}.get(bits_hint_for(repo_hint)) or 4
        if qmeta.get("bits") and quantize_bits and qmeta["bits"] != quantize_bits:
            raise ValueError(
                f"--quantize-bits {quantize_bits} conflicts with the checkpoint's quantization.json "
                f"bits={qmeta['bits']}"
            )
        for model in transformers:
            if not any(isinstance(m, QuantLinear) for m in model.modules()):
                quantize_dit_params(model, bits=bits)
            prepare_w4a8(model, bits=bits)
