"""Model-bundle loading: resolve the weight files of a snapshot and build the
components of a video pipeline (distilled, keyframe, IC-LoRA or dev), with
or without audio, on one device.

Counterpart of mlx_video_tpu/loading.py: the DiT of the pipeline's kind
(PyTorch, MLX, MLX pre-quantized or native layout; io/weights.py), VideoOnly,
or AudioVideo for joint audio, a second DiT for stage 2 from another
snapshot, the VAE decoder, the VAE encoder when conditionings need it, the 2x
upsampler when the snapshot has it, and with audio the audio VAE decoder and
the vocoder (io/vae_weights.py) and, for separate audio, an AudioOnly DiT
from the audio part of an AudioVideo file. :func:`quantize_models` applies
the quantized execution modes (4/8-bit storage on K2, W8A8, W4A8).
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
from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import AudioVAEConfig, init_audio_decoder
from mlx_video_tpu_torch.models.ltx.audio_vae.vocoder import VocoderConfig, init_vocoder
from mlx_video_tpu_torch.models.ltx.upsampler import init_latent_upsampler
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, init_video_decoder
from mlx_video_tpu_torch.models.ltx.video_vae.encoder import init_video_encoder
from mlx_video_tpu_torch.ops.int8 import quantize_params_w8a8
from mlx_video_tpu_torch.ops.linear import QuantLinear
from mlx_video_tpu_torch.ops.quant import prepare_w4a8, quantize_dit_params
from mlx_video_tpu_torch.pipelines.generate import ModelBundle, PipelineType

UNIFIED_FORMAT = "mlx_video_tpu_unified"
UPSAMPLER_FILE = "ltx-2-spatial-upscaler-x2-1.0.safetensors"


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
    """The 19B DiT configuration: AudioVideo for joint audio, else
    VideoOnly (the pipeline does not change it)."""
    return LTXModelConfig(model_type=LTXModelType.AudioVideo if audio else LTXModelType.VideoOnly,
                          rope_type=LTXRopeType.SPLIT, double_precision_rope=True)


def audio_only_config() -> LTXModelConfig:
    """The separate-audio transformer's configuration."""
    return LTXModelConfig(model_type=LTXModelType.AudioOnly, rope_type=LTXRopeType.SPLIT,
                          double_precision_rope=True)


def resolve_audio_transformer_file(model_path: Path, audio_model_path: Optional[Path] = None) -> Optional[Path]:
    """Weights of the separate-audio AudioOnly transformer: under
    ``audio_model_path``, then the snapshot, the dev weights before the
    distilled ones; None when there are none."""
    roots = [Path(p) for p in (audio_model_path, model_path) if p is not None]
    names = [
        "ltx-2-19b-dev-mlx.safetensors",
        "ltx-2-19b-dev.safetensors",
        "ltx-2-19b-distilled-mlx.safetensors",
        "ltx-2-19b-distilled.safetensors",
    ]
    for root in roots:
        for name in names:
            if (root / name).exists():
                return root / name
    return None


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
    audio_mode: str = "auto",
    audio_model_path: Optional[Path] = None,
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
    init, as the JAX loader fills its init.

    With ``audio``: the audio VAE decoder (``audio_vae/``) and the vocoder
    (``vocoder/``), or a unified bundle's; for joint audio (``audio_mode``
    "joint", or "auto" with the dev pipeline) an AudioVideo transformer, for
    separate audio a VideoOnly one and an AudioOnly one from the file
    :func:`resolve_audio_transformer_file` finds (``audio_model_path``
    first), none when there is none."""
    pipeline = PipelineType(pipeline)
    model_path = Path(model_path)
    device = torch.device(device)
    separate_audio = audio and (audio_mode == "separate" or (audio_mode == "auto" and pipeline != PipelineType.DEV))
    config = model_config_for(pipeline.value, audio and not separate_audio)
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

    audio_parts = {}
    if audio:
        def component(name: str) -> Path:
            path = model_path / name / "diffusion_pytorch_model.safetensors"
            return unified if unified is not None and not path.exists() else path

        if component("audio_vae").exists():
            cfg = AudioVAEConfig()
            decoder_a = init_audio_decoder(generator, cfg, device=device, dtype=dtype)
            vae_weights.load_audio_vae_weights(component("audio_vae"), decoder_a)
            audio_parts.update(audio_decoder=decoder_a, audio_decoder_config=cfg)
        if component("vocoder").exists():
            cfg = VocoderConfig()
            vocoder = init_vocoder(generator, cfg, device=device, dtype=dtype)
            vae_weights.load_vocoder_weights(component("vocoder"), vocoder)
            audio_parts.update(vocoder=vocoder, vocoder_config=cfg)
    if separate_audio:
        audio_file = resolve_audio_transformer_file(model_path, audio_model_path)
        if audio_file is not None:
            cfg = audio_only_config()
            audio_parts.update(audio_transformer=load_dit_params([audio_file], cfg, dtype=dtype, device=device),
                               audio_transformer_config=cfg)

    return ModelBundle(
        transformer=transformer,
        transformer_config=config,
        vae_decoder=decoder,
        vae_decoder_config=dec_cfg,
        upsampler=upsampler,
        vae_encoder=encoder,
        vae_encoder_config=enc_cfg,
        stage2_transformer=stage2,
        **audio_parts,
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
    """Apply the quantized execution mode to the loaded transformers (not the
    separate-audio one, as in JAX), in place (the JAX function of the same
    name; an AudioVideo transformer's audio and cross-modal linears are in
    the ``core`` scope):

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


def mesh_from_flag(spec: str, device_type: Optional[str] = None):
    """The (data, fsdp, tensor) mesh of a CLI flag value: "auto"
    (:func:`parallel.mesh.factor_devices` of the world size) or "d,f,t"."""
    from mlx_video_tpu_torch.parallel.distributed import ensure_world
    from mlx_video_tpu_torch.parallel.mesh import create_mesh, factor_devices

    shape = (factor_devices(ensure_world(device_type)) if spec == "auto"
             else tuple(int(x) for x in spec.split(",")))
    return create_mesh(shape, device_type)


def _transformer_fields(models: ModelBundle):
    return [f for f in ("transformer", "stage2_transformer", "audio_transformer") if getattr(models, f) is not None]


def shard_models(models: ModelBundle, mesh) -> None:
    """Shard the stage-1, stage-2 and audio transformers on the mesh, in
    place (parallel/sharding.py:shard_params: each keeps this rank's slices;
    a transformer already sharded on it stays as it is)."""
    from mlx_video_tpu_torch.parallel.sharding import shard_params

    for field in _transformer_fields(models):
        setattr(models, field, shard_params(getattr(models, field), mesh))


def stage_models(models: ModelBundle, num_stages: int, data: int = 1, tensor: int = 1, device_type=None):
    """Stage the stage-1, stage-2 and audio transformers over a pipeline
    mesh of ``num_stages`` stages, in place (parallel/pipeline.py:
    shard_params_pipeline; the mesh is the one the transformer is already
    staged on, else a new one over the world); returns the mesh."""
    from mlx_video_tpu_torch.parallel.pipeline import pipeline_mesh, shard_params_pipeline

    mesh = getattr(models.transformer, "mesh", None)
    if mesh is None:
        mesh = pipeline_mesh(num_stages, data=data, tensor=tensor,
                             device_type=device_type or models.transformer.video.scale_shift_table.device.type)
    for field in _transformer_fields(models):
        setattr(models, field, shard_params_pipeline(getattr(models, field), mesh))
    return mesh
