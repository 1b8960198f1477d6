"""Media IO for the reference pipelines.

Behavioral spec: reference ltx_pipelines/utils/media_io.py:16-299 (PyAV-based).
PyAV is not part of this stack; the same surface is provided over cv2/PIL and
the ffmpeg CLI (via the engine's io.media writers/mux), with NumPy arrays and
torch tensors in place of mx.array: the conditioning loaders and
``decode_audio_from_file`` return tensors on ``device`` (the CPU when it is
not given). Signatures and array contracts mirror the reference.
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess
import tempfile
import wave
from typing import Generator, Iterator, Optional, Union

import numpy as np

import torch

from mlx_video_tpu_torch.ltx_core.utils import device_or_card
from mlx_video_tpu_torch.ltx_pipelines.utils.constants import DEFAULT_IMAGE_CRF
from mlx_video_tpu_torch.io.media import (  # noqa: F401 (re-exported engine helpers)
    VideoWriter,
    frames_to_uint8,
    load_image,
    load_video,
    mux_audio,
    prepare_image_for_encoding,
    prepare_video_for_encoding,
    write_video,
)


def _to_numpy(value):
    """reference media_io.py:16-19 (mx.array -> np); tensors come back to the host."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    return np.asarray(value)


def resize_aspect_ratio_preserving(image, long_side: int) -> np.ndarray:
    """Resize so the LONG side hits ``long_side``, preserving aspect ratio
    (reference: media_io.py:22-43). Input (H, W, C) or (F, H, W, C); output
    (H, W, C) or (F, H, W, C)."""
    image_np = _to_numpy(image)
    height, width = image_np.shape[-3], image_np.shape[-2]
    scale = long_side / float(max(height, width))
    target_height = int(height * scale)
    target_width = int(width * scale)
    resized = resize_and_center_crop(image_np, target_height, target_width)
    result = resized.transpose(0, 2, 3, 4, 1)[0]  # (F, H, W, C)
    return result[0] if result.shape[0] == 1 else result


def resize_and_center_crop(tensor, height: int, width: int) -> np.ndarray:
    """Aspect-preserving fill resize + center crop (reference:
    media_io.py:45-78). Input (H, W, C) or (F, H, W, C); output
    (1, C, F, H, W) float/uint like the input."""
    import cv2

    arr = _to_numpy(tensor)
    if arr.ndim == 3:
        arr = arr[None, ...]
    elif arr.ndim != 4:
        raise ValueError(f"Expected input with 3 or 4 dimensions; got shape {arr.shape}.")

    _, src_h, src_w, _ = arr.shape
    scale = max(height / src_h, width / src_w)
    new_h = math.ceil(src_h * scale)
    new_w = math.ceil(src_w * scale)

    out_frames = []
    for frame in arr:
        frame_resized = cv2.resize(frame, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
        crop_top = (new_h - height) // 2
        crop_left = (new_w - width) // 2
        out_frames.append(
            frame_resized[crop_top : crop_top + height, crop_left : crop_left + width]
        )

    out = np.stack(out_frames, axis=0)  # (F, H, W, C)
    return out.transpose(3, 0, 1, 2)[None, ...]  # (1, C, F, H, W)


def normalize_latent(latent, dtype, device=None):
    """[0, 255] -> [-1, 1] (reference: media_io.py:80-81), a tensor on ``device``
    (the card when None)."""
    x = latent if isinstance(latent, torch.Tensor) else torch.from_numpy(np.asarray(latent, dtype=np.float32))
    return (x.to(device=device_or_card(device), dtype=torch.float32) / 127.5 - 1.0).to(dtype)


def load_image_conditioning(image_path: str, height: int, width: int, dtype, device=None):
    """(1, C, 1, H, W) in [-1, 1] (reference: media_io.py:84-92)."""
    image = decode_image(image_path=image_path)
    image = preprocess(image=image)
    image = resize_and_center_crop(image.astype(np.float32), height, width)
    return normalize_latent(image, dtype, device)


def load_video_conditioning(
    video_path: str, height: int, width: int, frame_cap: int, dtype, device=None
):
    """(1, C, F, H, W) in [-1, 1] (reference: media_io.py:95-106)."""
    chunks = []
    for f in decode_video_from_file(path=video_path, frame_cap=frame_cap, device=device):
        frame = resize_and_center_crop(_to_numpy(f)[0].astype(np.float32), height, width)
        chunks.append(normalize_latent(frame, dtype, device))
    if not chunks:
        raise ValueError(f"No frames decoded from {video_path}")
    return torch.cat(chunks, dim=2)


def decode_image(image_path: str) -> np.ndarray:
    """(reference: media_io.py:109-112)."""
    from PIL import Image

    # convert() first: on a grayscale (H, W) array `[..., :3]` would slice
    # the WIDTH axis, not channels.
    return np.array(Image.open(image_path).convert("RGB"))


def encode_video(
    video: Union[np.ndarray, Iterator],
    fps: Optional[float] = None,
    audio=None,
    audio_sample_rate: Optional[int] = None,
    output_path: Optional[str] = None,
    video_chunks_number: int = 0,
) -> str:
    """Stream (F, H, W, C) uint8 chunks into an MP4, optionally muxing audio
    (reference: media_io.py:177-226). Also accepts the engine's (B,3,F,H,W)
    [-1,1] layout for convenience."""
    if output_path is None:
        raise ValueError("output_path is required")
    fps = float(fps or 24.0)

    if isinstance(video, np.ndarray) or hasattr(video, "shape"):
        video = iter([_to_numpy(video)])
    else:
        video = iter(video)  # accept plain lists/tuples of chunks

    try:
        first = _to_numpy(next(video))
    except StopIteration:
        raise ValueError("encode_video got no frames") from None
    if first.ndim == 5:  # engine layout (B, 3, F, H, W) in [-1, 1]
        first = frames_to_uint8(first)
    _, height, width, _ = first.shape

    video_file = str(output_path)
    mux_later = audio is not None
    if mux_later:
        if audio_sample_rate is None:
            raise ValueError("audio_sample_rate is required when audio is provided")
        video_file = str(output_path) + ".temp.mp4"

    with VideoWriter(video_file, width, height, fps) as w:
        for chunk in _chain_first(first, video):
            chunk_np = _to_numpy(chunk)
            if chunk_np.ndim == 5:
                chunk_np = frames_to_uint8(chunk_np)
            if chunk_np.dtype != np.uint8:
                chunk_np = np.clip(chunk_np, 0, 255).astype(np.uint8)
            w.write(chunk_np)

    if mux_later:
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tf:
            wav_path = tf.name
        try:
            _write_wav(wav_path, _to_numpy(audio), int(audio_sample_rate))
            if mux_audio(video_file, wav_path, output_path,
                         audio_sample_rate=int(audio_sample_rate)):
                os.unlink(video_file)
            else:
                os.replace(video_file, output_path)
        finally:
            os.unlink(wav_path)
    return str(output_path)


def _chain_first(first, rest):
    yield first
    yield from rest


def _write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Stereo s16 WAV from (N,), (N, 2) or (2, N) float/-int samples
    (reference channel handling: media_io.py:115-140)."""
    if samples.ndim == 1:
        samples = samples[:, None]
    if samples.shape[1] != 2 and samples.shape[0] == 2:
        samples = samples.T
    if samples.shape[1] == 1:
        samples = np.repeat(samples, 2, axis=1)
    if samples.shape[1] != 2:
        raise ValueError(f"Expected samples with 2 channels; got shape {samples.shape}.")
    if samples.dtype != np.int16:
        samples = (np.clip(samples, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(samples.tobytes())


def decode_audio_from_file(path: str, device=None):
    """Audio track as a float32 (samples, channels) tensor on ``device`` (the
    card when None), or None (reference: media_io.py:228-246)."""
    p = str(path)
    device = device_or_card(device)
    if p.lower().endswith(".wav"):
        with wave.open(p, "rb") as w:
            data = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
            audio = data.reshape(-1, w.getnchannels()).astype(np.float32) / 32767.0
        return torch.from_numpy(audio).to(device)
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return None
    proc = subprocess.run(
        [ffmpeg, "-i", p, "-f", "s16le", "-acodec", "pcm_s16le", "-ac", "2", "-"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
    )
    if proc.returncode != 0 or not proc.stdout:
        return None
    data = np.frombuffer(proc.stdout, dtype=np.int16).reshape(-1, 2)
    return torch.from_numpy(data.astype(np.float32) / 32767.0).to(device)


def decode_video_from_file(path: str, frame_cap: int, device=None) -> Generator:
    """Yield (1, H, W, C) uint8 RGB frames (reference: media_io.py:249-261)."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    try:
        while frame_cap != 0:
            ret, frame = cap.read()
            if not ret:
                break
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)[None, ...]
            frame_cap -= 1
    finally:
        cap.release()


def encode_single_frame(output_file: str, image_array: np.ndarray, crf: float) -> None:
    """One-frame H.264 encode at the given CRF (reference: media_io.py:264-277).
    ``output_file`` is a path (the PyAV BytesIO mode is not supported)."""
    height = image_array.shape[0] // 2 * 2
    width = image_array.shape[1] // 2 * 2
    image_array = image_array[:height, :width]
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is not None:
        proc = subprocess.run(
            [
                ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
                "-s", f"{width}x{height}", "-r", "1", "-i", "-",
                "-c:v", "libx264", "-preset", "veryfast", "-crf", str(crf),
                "-pix_fmt", "yuv420p", "-f", "mp4", str(output_file),
            ],
            input=np.ascontiguousarray(image_array).tobytes(),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        )
        if proc.returncode == 0:
            return
    # cv2 fallback (codec default quality; no CRF control)
    with VideoWriter(output_file, width, height, 1.0, encoder="cv2") as w:
        w.write(image_array[None, ...])


def decode_single_frame(video_file: str) -> np.ndarray:
    """(reference: media_io.py:280-287)."""
    import cv2

    cap = cv2.VideoCapture(str(video_file))
    try:
        ret, frame = cap.read()
        if not ret:
            raise ValueError(f"No frame decoded from {video_file}")
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


def preprocess(image: np.ndarray, crf: float = DEFAULT_IMAGE_CRF) -> np.ndarray:
    """Round-trip the image through a CRF-quality H.264 encode so conditioning
    statistics match compressed video frames (reference: media_io.py:290-299).
    No-op at crf == 0 or when no encoder round-trip is possible."""
    if crf == 0:
        return image
    with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as tf:
        tmp = tf.name
    try:
        encode_single_frame(tmp, image, crf)
        if os.path.getsize(tmp) == 0:
            return image
        return decode_single_frame(tmp)
    except Exception:
        return image
    finally:
        os.unlink(tmp)
