"""Image and video loading and MP4 writing: the functions of
mlx_video_tpu/io/media.py that the port calls (load_image and
prepare_image_for_encoding, which resize with PIL's LANCZOS; load_video and
prepare_video_for_encoding, which read and resize with cv2; frames_to_uint8,
VideoWriter and write_video, with the cv2 codec probe they need; mux_audio,
which puts a WAV track into an mp4 with ffmpeg), copied whole
and unchanged in behaviour, so that the port imports nothing of the JAX
package.

Behavioral spec: reference mlx_video/utils.py:529-715 (load/prepare) and
mlx_video/generate.py:1814-2033, 3569-3857 (cv2 writer, ffmpeg pipe writer).
Host-side NumPy.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np


def load_image(
    image_path: Union[str, Path],
    height: Optional[int] = None,
    width: Optional[int] = None,
) -> np.ndarray:
    """Load an RGB image as (H, W, 3) float32 in [0, 1], resized to
    (height, width) or rounded down to /32 (reference: utils.py:529-573)."""
    from PIL import Image

    image = Image.open(image_path).convert("RGB")
    if height is not None and width is not None:
        image = image.resize((width, height), Image.Resampling.LANCZOS)
    elif height is not None or width is not None:
        ow, oh = image.size
        if height is not None:
            nw = (int(ow * height / oh) // 32) * 32
            image = image.resize((nw, height), Image.Resampling.LANCZOS)
        else:
            nh = (int(oh * width / ow) // 32) * 32
            image = image.resize((width, nh), Image.Resampling.LANCZOS)
    else:
        ow, oh = image.size
        nw, nh = (ow // 32) * 32, (oh // 32) * 32
        if (nw, nh) != (ow, oh):
            image = image.resize((nw, nh), Image.Resampling.LANCZOS)
    return np.asarray(image, dtype=np.float32) / 255.0


def load_video(
    video_path: Union[str, Path],
    height: Optional[int] = None,
    width: Optional[int] = None,
    frame_cap: Optional[int] = None,
) -> np.ndarray:
    """Load video frames as (F, H, W, 3) float32 in [0, 1]
    (reference: utils.py:576-609)."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise ValueError(f"Unable to open video: {video_path}")
    frames = []
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if height is not None and width is not None:
            frame = cv2.resize(frame, (width, height), interpolation=cv2.INTER_AREA)
        frames.append(frame.astype(np.float32) / 255.0)
        if frame_cap is not None and len(frames) >= frame_cap:
            break
    cap.release()
    if not frames:
        raise ValueError(f"No frames decoded from video: {video_path}")
    return np.stack(frames, axis=0)


def prepare_image_for_encoding(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, 3) [0,1] -> (1, 3, 1, H, W) in [-1, 1] (reference: utils.py:648-683)."""
    if image.shape[0] != height or image.shape[1] != width:
        from PIL import Image

        arr = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        image = (
            np.asarray(
                Image.fromarray(arr).resize((width, height), Image.Resampling.LANCZOS),
                dtype=np.float32,
            )
            / 255.0
        )
    out = image * 2.0 - 1.0
    return np.transpose(out, (2, 0, 1))[None, :, None]


def prepare_video_for_encoding(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """(F, H, W, 3) [0,1] -> (1, 3, F, H, W) in [-1, 1] (reference: utils.py:686-715)."""
    import cv2

    if frames.shape[1] != height or frames.shape[2] != width:
        frames = np.stack(
            [cv2.resize(f, (width, height), interpolation=cv2.INTER_AREA) for f in frames], axis=0
        )
    out = frames * 2.0 - 1.0
    return np.transpose(out, (3, 0, 1, 2))[None]


def frames_to_uint8(video: np.ndarray) -> np.ndarray:
    """(B, 3, F, H, W) [-1,1] -> (F, H, W, 3) uint8."""
    v = video[0] if video.ndim == 5 else video
    v = np.transpose(v, (1, 2, 3, 0))
    return (np.clip((v + 1.0) / 2.0, 0.0, 1.0) * 255).astype(np.uint8)


class _silenced_stderr:
    """fd-level stderr silencing for codec probes: OpenCV's VideoWriter and
    the libav encoders inside it write open-failure spew straight to fd 2
    (not Python's sys.stderr), so constrained pods without libx264 print
    `can't configure encoder` errors for every attempted writer. Probing
    codecs once behind a silenced fd keeps the honest fallback without the
    noise (r2 dryrun tail finding)."""

    def __enter__(self):
        self._saved = os.dup(2)
        self._null = os.open(os.devnull, os.O_WRONLY)
        os.dup2(self._null, 2)
        return self

    def __exit__(self, *exc):
        os.dup2(self._saved, 2)
        os.close(self._saved)
        os.close(self._null)
        return False


_CV2_FOURCC: Optional[str] = None


def _cv2_working_fourcc(fps: float, size: Tuple[int, int]) -> str:
    """Pick the first cv2 fourcc that actually opens on this pod, once per
    process, with the probe's encoder spew silenced."""
    global _CV2_FOURCC
    if _CV2_FOURCC is None:
        import tempfile

        import cv2

        with tempfile.TemporaryDirectory() as td, _silenced_stderr():
            for codec4 in ("avc1", "mp4v"):
                out = cv2.VideoWriter(
                    os.path.join(td, "probe.mp4"),
                    cv2.VideoWriter_fourcc(*codec4), fps, size,
                )
                ok = out.isOpened()
                out.release()
                if ok:
                    _CV2_FOURCC = codec4
                    break
            else:
                _CV2_FOURCC = ""
    return _CV2_FOURCC


class VideoWriter:
    """Streaming MP4 writer: ffmpeg rawvideo pipe with cv2 fallback
    (reference: generate.py:3583-3644, 1814-1917)."""

    def __init__(
        self,
        path: Union[str, Path],
        width: int,
        height: int,
        fps: float,
        encoder: str = "ffmpeg",
        crf: int = 18,
        preset: str = "veryfast",
        codec: str = "libx264",
    ):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.width, self.height, self.fps = width, height, fps
        self._ffmpeg: Optional[subprocess.Popen] = None
        self._cv2 = None
        self.frames_written = 0

        self._stderr_file = None
        # No pre-probe of the ffmpeg codec: ffmpeg's own failure surfaces
        # as a LOUD RuntimeError carrying its stderr (already captured to a
        # file, so nothing spews), and tests stub the binary to exercise
        # exactly that path. The quiet probing below is for the cv2
        # fallback, whose encoder errors bypass Python and land on fd 2.
        if encoder == "ffmpeg" and shutil.which("ffmpeg"):
            cmd = [
                "ffmpeg", "-y", "-hide_banner", "-nostats", "-loglevel", "error",
                "-f", "rawvideo", "-pix_fmt", "rgb24",
                "-s", f"{width}x{height}", "-r", str(fps), "-i", "-", "-an",
                "-c:v", codec, "-preset", preset, "-crf", str(crf),
                "-pix_fmt", "yuv420p", str(self.path),
            ]
            try:
                # stderr goes to a temp FILE, never a pipe: ffmpeg's default
                # per-frame stats fill a 64 KB stderr pipe on long encodes
                # and deadlock write()/close() (ffmpeg blocks on stderr,
                # stops reading stdin). A file can't fill, and close() can
                # still read it back to report a failed encode.
                import tempfile

                self._stderr_file = tempfile.TemporaryFile()
                self._ffmpeg = subprocess.Popen(
                    cmd, stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                    stderr=self._stderr_file,
                )
            except Exception:
                self._ffmpeg = None
                if self._stderr_file is not None:
                    self._stderr_file.close()
                    self._stderr_file = None
        if self._ffmpeg is None:
            import cv2

            codec4 = _cv2_working_fourcc(fps, (width, height))
            if codec4:
                out = cv2.VideoWriter(
                    str(self.path), cv2.VideoWriter_fourcc(*codec4), fps, (width, height)
                )
                if out.isOpened():
                    self._cv2 = out
                else:
                    out.release()
            if self._cv2 is None:
                raise RuntimeError(f"No video writer available for {self.path}")

    def write(self, frames_uint8: np.ndarray) -> None:
        """Write (F, H, W, 3) RGB uint8 frames."""
        if self._ffmpeg is not None and self._ffmpeg.stdin is not None:
            try:
                for frame in frames_uint8:
                    self._ffmpeg.stdin.write(np.ascontiguousarray(frame).tobytes())
                    self.frames_written += 1
            except BrokenPipeError:
                # ffmpeg died mid-encode: close() reads back its stderr and
                # raises the diagnostic instead of a bare broken pipe
                self.close()
                raise
        else:
            import cv2

            for frame in frames_uint8:
                self._cv2.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
                self.frames_written += 1

    def close(self) -> None:
        if self._ffmpeg is not None:
            proc, self._ffmpeg = self._ffmpeg, None  # idempotent close
            if proc.stdin is not None:
                proc.stdin.close()
            rc = proc.wait()
            err = b""
            if self._stderr_file is not None:
                try:
                    self._stderr_file.seek(0)
                    err = self._stderr_file.read()[-4096:]
                finally:
                    self._stderr_file.close()
                    self._stderr_file = None
            if rc != 0:
                # a failed encode must not 200 into a corrupt/empty MP4
                raise RuntimeError(
                    f"ffmpeg exited {rc} writing {self.path}: "
                    f"{err.decode(errors='replace').strip()}"
                )
        if self._cv2 is not None:
            self._cv2.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_video(path: Union[str, Path], video: np.ndarray, fps: float, encoder: str = "ffmpeg") -> None:
    """Write a full (B, 3, F, H, W) [-1,1] video tensor to MP4."""
    frames = frames_to_uint8(video)
    with VideoWriter(path, frames.shape[2], frames.shape[1], fps, encoder=encoder) as w:
        w.write(frames)


def mux_audio(
    video_path: Union[str, Path],
    audio_path: Union[str, Path],
    output_path: Union[str, Path],
    audio_filter: Optional[str] = None,
    audio_bitrate: str = "256k",
    audio_sample_rate: int = 24000,
) -> bool:
    """Mux a WAV track into an MP4 via ffmpeg (reference: generate.py:1980-2033
    mux_video_audio). Returns False when ffmpeg is unavailable or fails.

    Parity notes: explicit stream mapping (avoids ffmpeg picking wrong streams),
    AAC at ``audio_bitrate``, stereo at ``audio_sample_rate``, and deliberately
    NO ``-shortest`` — hop-size rounding can make audio slightly shorter than
    video and ``-shortest`` would drop the final frames. A filter value of
    none/off/false/0 disables the filter chain.
    """
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return False
    af = (audio_filter or "").strip()
    if af.lower() in {"none", "off", "false", "0"}:
        af = ""
    cmd = [
        ffmpeg, "-y",
        "-i", str(video_path),
        "-i", str(audio_path),
        "-map", "0:v:0",
        "-map", "1:a:0",
        "-c:v", "copy",
        "-c:a", "aac",
        "-b:a", str(audio_bitrate),
        "-ar", str(audio_sample_rate),
        "-ac", "2",
    ]
    if af:
        cmd += ["-af", af]
    cmd += ["-movflags", "+faststart", str(output_path)]
    result = subprocess.run(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    return result.returncode == 0
