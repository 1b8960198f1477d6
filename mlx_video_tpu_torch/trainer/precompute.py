"""Latent precompute: clips -> video latents, prompts -> caption embeddings,
audio tracks -> audio latents, in the trainer's directory layout.

Counterpart of mlx_video_tpu/trainer/precompute.py. The numpy, cv2 and
subprocess helpers are the port's own copies, unchanged in behaviour
(``parse_buckets``, ``bucket_score``, ``select_bucket``, ``match_frame_count``,
``resize_and_center_crop``, ``fit_to_bucket``, ``compute_edge_reference``,
``extract_audio_pcm`` and the prompts-file parsing of ``main``,
:func:`parse_prompts_file`). :func:`precompute_dataset` writes the same files,
keys and dtypes as the JAX function: ``latents/latent_<stem>``,
``conditions/condition_<stem>``, ``audio_latents/latent_<stem>`` and
``reference_latents/latent_<stem>`` (.safetensors), clips cut to 1 + 8k
frames after bucketing, reference clips conformed to the target's geometry.

The encoders are the port's modules on a device: the video VAE encoder
(:func:`make_video_encode_fn`), the Gemma-3 text encoder and connectors
(:func:`make_text_encode_fn`) and the audio VAE encoder behind the log-mel
processor (:func:`encode_waveform`, :func:`make_audio_encode_fn`). As in the
JAX package the VAE encoders get fp32 pixels and log-mels, so they compute
in fp32 over their (bf16) weights. Audio comes from the clip's own track
through ffmpeg; a clip without one (or a machine without ffmpeg) gets no
audio latents, as in JAX. ``--caption`` (BLIP captioning from the hub) is
not ported: captions come from ``--prompts-file``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

Bucket = Tuple[int, int, int]  # (W, H, F)


def parse_buckets(spec: str) -> List[Bucket]:
    """'WxHxF;WxHxF' -> [(W, H, F), ...]."""
    buckets = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        w, h, f = (int(x) for x in part.lower().split("x"))
        buckets.append((w, h, f))
    if not buckets:
        raise ValueError(f"No buckets parsed from {spec!r}")
    return buckets


def bucket_score(frames: int, height: int, width: int, bucket: Bucket) -> float:
    """Relative-delta distance."""
    w, h, f = bucket
    return (
        abs(frames - f) / max(f, 1)
        + abs(height - h) / max(h, 1)
        + abs(width - w) / max(w, 1)
    )


def select_bucket(frames: np.ndarray, buckets: List[Bucket]) -> Bucket:
    """Nearest bucket for an (F, H, W, C) clip."""
    f, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    return min(buckets, key=lambda b: bucket_score(f, h, w, b))


def match_frame_count(frames: np.ndarray, target_f: int) -> np.ndarray:
    """Trim, or pad by repeating the last frame."""
    if frames.shape[0] >= target_f:
        return frames[:target_f]
    pad = target_f - frames.shape[0]
    return np.concatenate([frames, np.repeat(frames[-1:], pad, axis=0)], axis=0)


def resize_and_center_crop(frames: np.ndarray, target_h: int, target_w: int) -> np.ndarray:
    """Cover-scale then center crop."""
    if frames.shape[1] == target_h and frames.shape[2] == target_w:
        return frames
    import cv2

    h, w = frames.shape[1], frames.shape[2]
    scale = max(target_w / float(w), target_h / float(h))
    new_w, new_h = int(round(w * scale)), int(round(h * scale))
    resized = np.stack(
        [cv2.resize(f, (new_w, new_h), interpolation=cv2.INTER_AREA) for f in frames]
    )
    sx = max((new_w - target_w) // 2, 0)
    sy = max((new_h - target_h) // 2, 0)
    return resized[:, sy : sy + target_h, sx : sx + target_w]


def fit_to_bucket(frames: np.ndarray, bucket: Bucket) -> np.ndarray:
    w, h, f = bucket
    frames = match_frame_count(frames, f)
    return resize_and_center_crop(frames, h, w)


def _host(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or array as a host array;
    floating values as fp32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


def _save(path: Path, values: Dict[str, object]) -> None:
    """Arrays and tensors (kept in their dtypes) to a safetensors file."""
    from mlx_video_tpu_torch.io.safetensors import save_safetensors

    save_safetensors(path, {k: v.detach().cpu().contiguous() if isinstance(v, torch.Tensor)
                            else torch.from_numpy(np.array(v)) for k, v in values.items()})


def _latent_file(latents: np.ndarray, fps: float) -> Dict[str, np.ndarray]:
    return {
        "latents": latents,
        "num_frames": np.array([latents.shape[1]], np.int32),
        "height": np.array([latents.shape[2]], np.int32),
        "width": np.array([latents.shape[3]], np.int32),
        "fps": np.array([fps], np.float32),
    }


def precompute_dataset(
    videos: List[Path],
    output_root: Path,
    encode_fn: Callable[[np.ndarray], object],
    text_encode_fn: Optional[Callable[[str], Dict[str, object]]] = None,
    prompts: Optional[Dict[str, str]] = None,
    buckets: Optional[List[Bucket]] = None,
    audio_encode_fn: Optional[Callable[[Path], object]] = None,
    reference_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    fps: float = 24.0,
    frame_cap: Optional[int] = None,
    caption_fn: Optional[Callable[[Path], str]] = None,
    reference_dir: Optional[Path] = None,
) -> int:
    """Encode clips into the trainer's directory layout; returns the number
    of clips written.

    encode_fn: (1, 3, F, H, W) fp32 numpy in [-1, 1] -> (1, C, f, h, w)
    latents (a tensor or an array). text_encode_fn: prompt ->
    {"video_prompt_embeds", ...}. audio_encode_fn: clip path -> audio
    latents or a payload dict, or None to skip the clip's audio.
    reference_fn: frames in [0, 1] -> reference frames (e.g. edge maps) for
    IC-LoRA training. Video latents are written in fp32, the other values
    in their own dtypes.
    """
    from mlx_video_tpu_torch.io.media import load_video, prepare_video_for_encoding

    out = Path(output_root)
    (out / "latents").mkdir(parents=True, exist_ok=True)
    (out / "conditions").mkdir(exist_ok=True)
    if audio_encode_fn is not None:
        (out / "audio_latents").mkdir(exist_ok=True)
    if reference_fn is not None or reference_dir is not None:
        (out / "reference_latents").mkdir(exist_ok=True)

    count = 0
    for video_path in videos:
        frames = load_video(video_path, frame_cap=frame_cap)  # (F, H, W, 3) in [0, 1]
        if buckets:
            frames = fit_to_bucket(frames, select_bucket(frames, buckets))
        valid_f = max(((frames.shape[0] - 1) // 8) * 8 + 1, 1)  # 1 + 8k frames
        frames = frames[:valid_f]

        tensor = prepare_video_for_encoding(frames, frames.shape[1], frames.shape[2]).astype(np.float32)
        latents = _host(encode_fn(tensor)).astype(np.float32)[0]
        stem = video_path.stem
        _save(out / "latents" / f"latent_{stem}.safetensors", _latent_file(latents, fps))

        prompt = (prompts or {}).get(stem, "")
        if not prompt and caption_fn is not None:
            prompt = caption_fn(video_path)
        if text_encode_fn is not None:
            cond = text_encode_fn(prompt)
        else:
            cond = {"prompt": np.frombuffer(prompt.encode() or b"\x00", dtype=np.uint8)}
        _save(out / "conditions" / f"condition_{stem}.safetensors", cond)

        if audio_encode_fn is not None:
            audio_lat = audio_encode_fn(video_path)
            if audio_lat is not None:
                # a bare latent array, or the whole payload (latents,
                # num_time_steps, frequency_bins, duration)
                if not isinstance(audio_lat, dict):
                    audio_lat = {"latents": _host(audio_lat).astype(np.float32)}
                _save(out / "audio_latents" / f"latent_{stem}.safetensors", audio_lat)
        ref_frames = None
        if reference_dir is not None:
            ref_path = Path(reference_dir) / video_path.name
            if ref_path.exists():
                # conformed to the target's final geometry: reference latents
                # stack against the target's in a batch, and a short reference
                # clip still keeps the 1 + 8k frames
                ref_frames = resize_and_center_crop(
                    match_frame_count(load_video(ref_path, frame_cap=frame_cap), valid_f),
                    frames.shape[1], frames.shape[2],
                )
        elif reference_fn is not None:
            ref_frames = reference_fn(frames)
        if ref_frames is not None:
            ref_tensor = prepare_video_for_encoding(ref_frames, frames.shape[1], frames.shape[2]).astype(np.float32)
            ref_lat = _host(encode_fn(ref_tensor)).astype(np.float32)[0]
            _save(out / "reference_latents" / f"latent_{stem}.safetensors", _latent_file(ref_lat, fps))
        count += 1
    return count


def extract_audio_pcm(
    path: Path, sample_rate: int, channels: int = 2
) -> Optional[Tuple[np.ndarray, int]]:
    """Extract PCM via ffmpeg: (waveform (channels, samples) in [-1, 1], rate),
    or None when the clip has no audio track (or there is no ffmpeg)."""
    import subprocess

    cmd = [
        "ffmpeg", "-y", "-i", str(path), "-vn",
        "-ac", str(channels), "-ar", str(sample_rate), "-f", "s16le", "-",
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True)
    except FileNotFoundError:
        return None
    if proc.returncode != 0 or not proc.stdout:
        return None
    data = np.frombuffer(proc.stdout, dtype=np.int16)
    if data.size == 0:
        return None
    waveform = data.reshape(-1, channels).T.astype(np.float32) / 32768.0
    return waveform, sample_rate


def encode_waveform(encoder, config, processor, waveform: np.ndarray, sample_rate: int) -> Dict[str, np.ndarray]:
    """A (channels, samples) waveform -> the audio latents file's payload:
    log-mel (``processor``), then the audio VAE encoder on its device in
    fp32 activations: {latents (z, T', M') fp32, num_time_steps,
    frequency_bins, duration (seconds)}."""
    from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import audio_encoder_apply

    mel = processor.waveform_to_mel(waveform, sample_rate)  # (1, ch, time, mel)
    device = encoder.conv_in.weight.device
    with torch.no_grad():
        latents = _host(audio_encoder_apply(encoder, config, torch.from_numpy(mel).to(device)))
    return {
        "latents": latents[0],
        "num_time_steps": np.array([latents.shape[2]], np.int32),
        "frequency_bins": np.array([latents.shape[3]], np.int32),
        "duration": np.array([waveform.shape[1] / float(sample_rate)], np.float32),
    }


def audio_processor_for(config):
    from mlx_video_tpu_torch.models.ltx.audio_vae.processing import AudioProcessor

    return AudioProcessor(sample_rate=config.sample_rate, mel_bins=config.mel_bins,
                          mel_hop_length=config.mel_hop_length)


def make_audio_encode_fn(model_path: Path, dtype=torch.bfloat16, device="cuda") -> Callable[[Path], Optional[dict]]:
    """Clip path -> audio latents payload: ffmpeg PCM -> log-mel -> the
    default audio VAE encoder, loaded from ``model_path``'s ``audio_vae/``
    (or its unified ``model.safetensors``), every parameter from the file."""
    from mlx_video_tpu_torch.io import vae_weights
    from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import AudioVAEConfig, init_audio_encoder

    config = AudioVAEConfig()
    audio_file = Path(model_path) / "audio_vae" / "diffusion_pytorch_model.safetensors"
    if not audio_file.exists():
        audio_file = Path(model_path) / "model.safetensors"
        if not audio_file.exists():
            raise FileNotFoundError(f"No audio VAE weights under {model_path}")
    encoder = init_audio_encoder(torch.Generator(device=device).manual_seed(0), config, device=device, dtype=dtype)
    vae_weights.load_audio_vae_weights(audio_file, encoder=encoder)
    processor = audio_processor_for(config)

    def encode(video_path: Path) -> Optional[dict]:
        extracted = extract_audio_pcm(video_path, processor.sample_rate)
        if extracted is None:
            print(f"[precompute] No audio track for {video_path.name}, skipping.")
            return None
        return encode_waveform(encoder, config, processor, *extracted)

    return encode


def make_video_encode_fn(encoder, config) -> Callable[[np.ndarray], torch.Tensor]:
    """(1, 3, F, H, W) fp32 numpy -> latents on the encoder's device, in
    fp32 activations."""
    from mlx_video_tpu_torch.models.ltx.video_vae.encoder import video_encoder_apply

    device = encoder.conv_in.weight.device

    def encode(pixels: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return video_encoder_apply(encoder, config, torch.from_numpy(pixels).to(device))

    return encode


def make_text_encode_fn(encode: Callable[[str], Tuple[torch.Tensor, torch.Tensor]]) -> Callable[[str], dict]:
    """prompt -> the conditions file's payload from ``encode`` (prompt ->
    (video, audio) embeddings (1, S, D)): fp32 embeddings and an all-ones
    mask of S, as the JAX CLI writes them."""

    def text_encode(prompt: str) -> Dict[str, np.ndarray]:
        video, audio = encode(prompt)
        return {
            "video_prompt_embeds": _host(video[0]).astype(np.float32),
            "audio_prompt_embeds": _host(audio[0]).astype(np.float32),
            "prompt_attention_mask": np.ones((video.shape[1],), bool),
        }

    return text_encode


def compute_edge_reference(frames: np.ndarray) -> np.ndarray:
    """Canny edge maps as IC-LoRA reference frames."""
    import cv2

    out = []
    for f in frames:
        gray = cv2.cvtColor((f * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
        edges = cv2.Canny(gray, 100, 200).astype(np.float32) / 255.0
        out.append(np.stack([edges] * 3, axis=-1))
    return np.stack(out, axis=0)


def parse_prompts_file(text: str, stems) -> Dict[str, str]:
    """'<stem>: <prompt>' lines; a file whose lines name no clip stem is one
    prompt shared by every clip (a colon inside it does not split it)."""
    prompts = {}
    stems = set(stems)
    for line in text.splitlines():
        if ":" in line:
            stem, prompt = line.split(":", 1)
            prompts[stem.strip()] = prompt.strip()
    if text.strip() and not (prompts.keys() & stems):
        shared = " ".join(text.split())
        prompts = {s: shared for s in stems}
    return prompts


def copy_audio_latents_fn(audio_src: Path) -> Callable[[Path], Optional[dict]]:
    """Copy mode: a clip's audio latents read from an earlier pass's file
    (``latent_<stem>`` or ``<stem>``) instead of encoded."""
    from mlx_video_tpu_torch.io.safetensors import SafetensorsReader

    audio_src = Path(audio_src)

    def audio_encode_fn(video_path: Path):
        for name in (f"latent_{video_path.stem}.safetensors", f"{video_path.stem}.safetensors"):
            src = audio_src / name
            if src.exists():
                with SafetensorsReader(src) as r:
                    return {k: r.get(k) for k in r.keys()}
        print(f"[precompute] Missing audio latents for {video_path.stem}, skipping.")
        return None

    return audio_encode_fn


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Precompute latents for training (PyTorch, CUDA)")
    parser.add_argument("--videos", "--input-dir", required=True, dest="videos",
                        help="Directory of input videos")
    parser.add_argument("--output", "--output-dir", required=True, dest="output",
                        help="Output dataset root")
    parser.add_argument("--model-repo", default="Lightricks/LTX-2")
    parser.add_argument("--text-encoder-repo", default=None)
    parser.add_argument("--resolution-buckets", default=None, help="WxHxF;WxHxF")
    parser.add_argument("--prompts-file", default=None,
                        help="File of '<stem>: <prompt>' lines or a single shared prompt")
    parser.add_argument("--caption", action="store_true",
                        help="Auto-caption clips missing a prompt (not ported: exits)")
    parser.add_argument("--caption-model", default="Salesforce/blip-image-captioning-base",
                        help="Captioning model (inert: --caption exits)")
    parser.add_argument("--caption-backend", default="transformers", choices=["transformers", "mlx_vlm"],
                        help="Captioning backend (inert: --caption exits)")
    parser.add_argument("--audio", "--with-audio", action="store_true", dest="audio",
                        help="Encode each clip's audio track to mel latents "
                             "(ffmpeg PCM -> log-mel -> AudioEncoder)")
    parser.add_argument("--audio-latents-dir", default=None,
                        help="Copy precomputed audio latents from this dir instead of encoding")
    parser.add_argument("--reference-edges", action="store_true",
                        help="Write Canny-edge reference latents (IC-LoRA)")
    parser.add_argument("--reference-dir", default=None,
                        help="Reference videos for video_to_video precompute")
    parser.add_argument("--frame-cap", type=int, default=None)
    parser.add_argument("--fps", type=float, default=24.0)
    parser.add_argument("--debug", action="store_true", help="Accepted; this package has no debug output")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the encoders (default cuda; exits when CUDA is absent)")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.caption:
        raise SystemExit("precompute: --caption (automatic captioning with a BLIP model from the hub) is not "
                         "ported to mlx_video_tpu_torch; give the captions with --prompts-file")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("precompute: --device cuda but CUDA is not available (pass --device cpu to run on the CPU)")
    if args.debug:
        print("precompute: --debug is accepted but this package prints no debug output", flush=True)

    from mlx_video_tpu_torch.config import VideoVAEConfig
    from mlx_video_tpu_torch.io import vae_weights
    from mlx_video_tpu_torch.loading import resolve_vae_file
    from mlx_video_tpu_torch.models.ltx.text_encoder import LTX2TextEncoder
    from mlx_video_tpu_torch.models.ltx.video_vae.encoder import init_video_encoder
    from mlx_video_tpu_torch.utils.hub import get_model_path

    model_path = get_model_path(args.model_repo)
    enc_cfg = VideoVAEConfig()
    encoder = init_video_encoder(torch.Generator(device=device).manual_seed(0), enc_cfg, device=device,
                                 dtype=torch.bfloat16)
    vae_weights.load_video_encoder_weights(resolve_vae_file(model_path), encoder)

    te_path = get_model_path(args.text_encoder_repo) if args.text_encoder_repo else model_path
    text_encoder = LTX2TextEncoder.load(model_path, te_path, device=device)

    videos = sorted(p for p in Path(args.videos).iterdir() if p.suffix.lower() in (".mp4", ".mov", ".webm"))
    prompts = {}
    if args.prompts_file:
        prompts = parse_prompts_file(Path(args.prompts_file).read_text(), (p.stem for p in videos))
    audio_encode_fn = None
    if args.audio_latents_dir:
        audio_encode_fn = copy_audio_latents_fn(Path(args.audio_latents_dir))
    elif args.audio:
        audio_encode_fn = make_audio_encode_fn(model_path, device=device)

    n = precompute_dataset(
        videos,
        Path(args.output),
        encode_fn=make_video_encode_fn(encoder, enc_cfg),
        text_encode_fn=make_text_encode_fn(text_encoder.encode),
        prompts=prompts,
        buckets=parse_buckets(args.resolution_buckets) if args.resolution_buckets else None,
        audio_encode_fn=audio_encode_fn,
        reference_fn=compute_edge_reference if args.reference_edges else None,
        reference_dir=Path(args.reference_dir) if args.reference_dir else None,
        frame_cap=args.frame_cap,
        fps=args.fps,
    )
    print(f"Precomputed {n} clips into {args.output}")


if __name__ == "__main__":
    main()
