"""WAV writing: the port's own copy of ``save_wav`` of
mlx_video_tpu/models/ltx/audio_vae/processing.py (numpy and the standard
library's ``wave``, copied unchanged in behaviour), so that the port imports
nothing of the JAX package.

Not ported yet: ``AudioProcessor`` (log-mel spectrograms, audio precompute).
"""

from __future__ import annotations

import numpy as np


def save_wav(path: str, waveform: np.ndarray, sample_rate: int = 24000) -> None:
    """Write (channels, samples) float waveform in [-1, 1] as 16-bit WAV."""
    import wave

    wav = np.clip(np.asarray(waveform, dtype=np.float32), -1.0, 1.0)
    if wav.ndim == 1:
        wav = wav[None]
    pcm = (wav * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as wf:
        wf.setnchannels(pcm.shape[0])
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm.T.tobytes())
