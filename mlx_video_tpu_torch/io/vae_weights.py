"""Checkpoint loaders for the video VAE decoder and encoder, the latent
upsampler, the audio VAE decoder and encoder and the vocoder.

Counterpart of the decoder, encoder, upsampler, audio VAE and vocoder loaders of
mlx_video_tpu/io/vae_weights.py, with the same prefixes, the same key remapping
(``mid_block.resnets.i`` -> ``up_blocks.0.res_blocks.i``,
``up_blocks.b.resnets.i`` -> ``up_blocks.(2b+2).res_blocks.i``,
``up_blocks.b.upsamplers.0`` -> ``up_blocks.(2b+1)``) and the same
preference among the latent-statistics names. Conv weights keep the
checkpoint's ``(O, I, k...)`` layout and linears its ``(out, in)``: both are
the port's, so nothing is transposed; the port's res blocks are a
``ModuleList``, so nothing is stacked either.

The loaders fill a built module in place (values cast to its dtypes and
device) and return the number of tensors loaded; a tensor whose shape does
not match raises. The audio loaders are strict where the JAX ones are not:
a file that leaves a parameter of the module unfilled raises (the JAX
loaders keep the init's values). Audio conv weights keep their checkpoint
layouts too: Conv2d (O, I, kh, kw), Conv1d (O, I, K) and ConvTranspose1d
(I, O, K).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple, Union

import torch
from torch import nn

from mlx_video_tpu_torch.io.safetensors import SafetensorsReader


def _leaf_candidates(parts) -> list:
    """Candidate names for a checkpoint key: checkpoints may nest conv
    weights under an extra ``.conv`` module (CausalConv wrappers) while some
    of the port's modules are legitimately named ``conv``."""
    parts = list(parts)
    cands = [tuple(parts)]
    if len(parts) >= 2 and parts[-2] == "conv":
        cands.append(tuple(parts[:-2] + parts[-1:]))  # strip one .conv
    if parts[-1] in ("weight", "bias"):
        cands.append(tuple(parts[:-1] + ["conv", parts[-1]]))  # add one .conv
    return cands


@torch.no_grad()
def _assign(state: Dict[str, torch.Tensor], path: Tuple[str, ...], value: torch.Tensor) -> bool:
    target = state.get(".".join(path))
    if target is None:
        return False
    if tuple(target.shape) != tuple(value.shape):
        raise ValueError(
            f"Shape mismatch for {'.'.join(path)}: checkpoint {tuple(value.shape)} vs expected {tuple(target.shape)}"
        )
    target.copy_(value)
    return True


def _assign_any(state: Dict[str, torch.Tensor], parts, value: torch.Tensor) -> bool:
    return any(_assign(state, cand, value) for cand in _leaf_candidates(parts))


def _read_all(path: Union[str, Path], prefixes: Iterable[str], device) -> Dict[str, torch.Tensor]:
    """Read tensors whose key starts with one of the prefixes (stripped)."""
    out = {}
    with SafetensorsReader(path) as r:
        for key in r.keys():
            for prefix in prefixes:
                if key.startswith(prefix):
                    out[key[len(prefix) :]] = r.get(key, device)
                    break
    return out


def _read_stats(path: Union[str, Path], prefixes: Iterable[str], names: Iterable[str]) -> Dict[str, torch.Tensor]:
    """Read only the small per-channel statistics vectors: keys that are
    ``prefix + name`` for some prefix and name (never the whole file)."""
    names = set(names)
    out: Dict[str, torch.Tensor] = {}
    with SafetensorsReader(path) as r:
        for key in r.keys():
            for prefix in prefixes:
                if key.startswith(prefix) and key[len(prefix) :] in names:
                    out.setdefault(key[len(prefix) :], r.get(key))
                    break
    return out


def _detect_prefixes(path: Union[str, Path], options) -> Tuple[str, ...]:
    with SafetensorsReader(path) as r:
        keys = r.keys()
    for opts in options:
        if any(k.startswith(opts[0]) for k in keys):
            return opts
    return ("",)


def _remap_decoder_key(key: str) -> str:
    parts = key.split(".")
    if len(parts) >= 4 and parts[0] == "mid_block" and parts[1] == "resnets":
        return ".".join(["up_blocks", "0", "res_blocks", parts[2]] + parts[3:])
    if len(parts) >= 3 and parts[0] == "mid_block" and parts[1] == "time_embedder":
        return ".".join(["up_blocks", "0"] + parts[1:])
    if len(parts) >= 3 and parts[0] == "up_blocks" and parts[1].isdigit():
        b = int(parts[1])
        if len(parts) >= 4 and parts[2] == "resnets":
            return ".".join(["up_blocks", str(2 * b + 2), "res_blocks", parts[3]] + parts[4:])
        if len(parts) >= 5 and parts[2] == "upsamplers" and parts[3] == "0":
            return ".".join(["up_blocks", str(2 * b + 1)] + parts[4:])
        if parts[2] == "time_embedder":
            return ".".join(["up_blocks", str(2 * b + 2)] + parts[2:])
    return key


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def load_video_decoder_weights(path: Union[str, Path], decoder: nn.Module) -> int:
    """Fill a ``VideoDecoder`` from a checkpoint, in place."""
    device = _device_of(decoder)
    prefixes = _detect_prefixes(path, [("vae.decoder.",), ("decoder.",), ("vae_decoder.",)])
    weights = _read_all(path, prefixes, device)
    stats = _read_stats(
        path,
        ("vae.per_channel_statistics.", "vae_decoder.per_channel_statistics.", "per_channel_statistics.", ""),
        ("mean-of-means", "mean", "latents_mean", "std-of-means", "std", "latents_std"),
    )
    state = decoder.state_dict()
    loaded = 0
    for target, names in (("latents_mean", ("mean-of-means", "mean", "latents_mean")),
                          ("latents_std", ("std-of-means", "std", "latents_std"))):
        for name in names:
            if name in stats:
                _assign(state, (target,), stats[name].float())
                loaded += 1
                break
    for key, value in weights.items():
        k = _remap_decoder_key(key.replace(".conv.conv.", ".conv."))
        parts = [p for p in k.split(".") if p != "timestep_embedder"]
        if _assign_any(state, parts, value):
            loaded += 1
    return loaded


def load_upsampler_weights(path: Union[str, Path], upsampler: nn.Module) -> int:
    """Fill a ``LatentUpsampler`` from a checkpoint, in place. A plain
    upsampler file has a top-level ``upsampler.`` module of its own
    (``upsampler.conv.weight``), so ``upsampler.`` is taken as a bundle
    prefix only when the bundle-nested keys are there."""
    with SafetensorsReader(path) as r:
        keys = r.keys()
    bundled = any(
        k.startswith(("upsampler.initial_conv", "upsampler.res_blocks", "upsampler.upsampler.")) for k in keys
    )
    weights = _read_all(path, ("upsampler.",) if bundled else ("",), _device_of(upsampler))
    state = upsampler.state_dict()
    return sum(_assign(state, tuple(key.split(".")), value) for key, value in weights.items())


def load_video_encoder_weights(path: Union[str, Path], encoder: nn.Module) -> int:
    """Fill a ``VideoEncoder`` from a checkpoint, in place: the ``vae.encoder.``,
    ``encoder.`` or ``vae_encoder.`` tensors and the latent statistics
    (``mean-of-means`` or ``mean``, ``std-of-means`` or ``std``)."""
    prefixes = _detect_prefixes(path, [("vae.encoder.",), ("encoder.",), ("vae_encoder.",)])
    weights = _read_all(path, prefixes, _device_of(encoder))
    stats = _read_stats(
        path,
        ("vae.per_channel_statistics.", "vae_encoder.per_channel_statistics.", "per_channel_statistics.", ""),
        ("mean-of-means", "mean", "std-of-means", "std"),
    )
    state = encoder.state_dict()
    loaded = 0
    for target, names in (("per_channel_statistics.mean", ("mean-of-means", "mean")),
                          ("per_channel_statistics.std", ("std-of-means", "std"))):
        for name in names:
            if name in stats:
                _assign(state, tuple(target.split(".")), stats[name].float())
                loaded += 1
                break
    for key, value in weights.items():
        if _assign_any(state, key.split("."), value):
            loaded += 1
    return loaded


def _check_filled(what: str, state: Dict[str, torch.Tensor], filled: set) -> None:
    missing = sorted(n for n in state if n not in filled)
    if missing:
        raise ValueError(f"{what}: {len(missing)} parameters not in the file (sample: {missing[:20]})")


_AUDIO_STATS = {
    "std_of_means": ("std_of_means", "std-of-means", "_std_of_means"),
    "mean_of_means": ("mean_of_means", "mean-of-means", "_mean_of_means"),
}


def load_audio_vae_weights(path: Union[str, Path], decoder: Optional[nn.Module] = None,
                           encoder: Optional[nn.Module] = None) -> int:
    """Fill an ``AudioDecoder`` and/or an ``AudioEncoder`` from a checkpoint,
    in place: the ``decoder.`` / ``encoder.`` tensors (or a unified
    bundle's ``audio_vae.decoder.`` / ``audio_vae.encoder.``) and the
    per-channel statistics, which both share, under any of their three
    spellings. Every parameter of each module given must be in the file.
    Returns the number of tensors loaded over both."""
    stats = _read_stats(path, ("per_channel_statistics.", "audio_vae.per_channel_statistics."),
                        [n for names in _AUDIO_STATS.values() for n in names])
    loaded = 0
    for what, module, prefixes in (("audio VAE decoder", decoder, ("decoder.", "audio_vae.decoder.")),
                                   ("audio VAE encoder", encoder, ("encoder.", "audio_vae.encoder."))):
        if module is None:
            continue
        weights = _read_all(path, prefixes, _device_of(module))
        state = module.state_dict()
        filled = set()
        for target, names in _AUDIO_STATS.items():
            name = next((n for n in names if n in stats), None)
            if name is not None and _assign(state, ("per_channel_statistics", target), stats[name].float()):
                filled.add(f"per_channel_statistics.{target}")
        for key, value in weights.items():
            # CausalConv2d wrappers nest the conv one level deeper (.conv)
            cand = next((c for c in _leaf_candidates(key.split(".")) if _assign(state, c, value)), None)
            if cand is not None:
                filled.add(".".join(cand))
        _check_filled(what, state, filled)
        loaded += len(filled)
    return loaded


def load_vocoder_weights(path: Union[str, Path], vocoder: nn.Module) -> int:
    """Fill a ``Vocoder`` from a checkpoint (``vocoder.``-prefixed keys, or
    bare ones), in place. Every parameter must be in the file."""
    weights = _read_all(path, _detect_prefixes(path, [("vocoder.",)]), _device_of(vocoder))
    state = vocoder.state_dict()
    filled = {key for key, value in weights.items() if _assign(state, tuple(key.split(".")), value)}
    _check_filled("vocoder", state, filled)
    return len(filled)
