"""Waveform -> log-mel spectrogram (``AudioProcessor``) and WAV writing
(``save_wav``): the port's own copies of mlx_video_tpu/models/ltx/audio_vae/
processing.py (host numpy and the standard library's ``wave``, copied
unchanged in behaviour), so that the port imports nothing of the JAX package.

``AudioProcessor`` turns a (channels, samples) waveform into the audio VAE
encoder's (1, channels, time, mel) log-mel input: a linear-interpolation
resample to ``sample_rate``, a non-centred Hann-window magnitude STFT, a
triangular mel filterbank and the log clipped at 1e-5. It runs on the host:
audio precompute is file reading, not device work.
"""

from __future__ import annotations

import numpy as np


class AudioProcessor:
    def __init__(
        self, sample_rate: int = 16000, mel_bins: int = 64, mel_hop_length: int = 160, n_fft: int = 1024
    ) -> None:
        self.sample_rate = int(sample_rate)
        self.mel_bins = int(mel_bins)
        self.mel_hop_length = int(mel_hop_length)
        self.n_fft = int(n_fft)

    def resample(self, waveform: np.ndarray, source_rate: int) -> np.ndarray:
        """Linear-interpolation resample, (channels, samples)."""
        if source_rate == self.sample_rate:
            return waveform
        num = int(round(waveform.shape[1] * self.sample_rate / float(source_rate)))
        xp = np.linspace(0, 1, waveform.shape[1])
        xq = np.linspace(0, 1, num)
        return np.stack([np.interp(xq, xp, ch) for ch in waveform], axis=0).astype(np.float32)

    def stft_magnitude(self, waveform: np.ndarray) -> np.ndarray:
        """Hann-window magnitude STFT, (channels, freq, frames); frames are
        non-centered (reference: ops.py:140-160), vectorized via stride tricks."""
        win = np.hanning(self.n_fft).astype(np.float32)
        hop = self.mel_hop_length
        n_fft = self.n_fft
        samples = waveform.shape[1]
        frames = 1 + max((samples - n_fft) // hop, 0)
        if samples < n_fft:
            waveform = np.pad(waveform, ((0, 0), (0, n_fft - samples)))
            frames = 1
        strided = np.lib.stride_tricks.sliding_window_view(waveform, n_fft, axis=1)[:, ::hop][
            :, :frames
        ]
        spec = np.fft.rfft(strided * win, axis=-1)
        return np.abs(spec).transpose(0, 2, 1).astype(np.float32)

    def mel_filter(self) -> np.ndarray:
        """Triangular mel filterbank (reference: ops.py:162-193)."""
        sr, n_fft, n_mels = self.sample_rate, self.n_fft, self.mel_bins

        def hz_to_mel(hz):
            return 2595.0 * np.log10(1.0 + hz / 700.0)

        def mel_to_hz(mel):
            return 700.0 * (10 ** (mel / 2595.0) - 1.0)

        m_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2)
        bins = np.floor((n_fft + 1) * mel_to_hz(m_pts) / sr).astype(int)
        fb = np.zeros((n_mels, n_fft // 2 + 1), dtype=np.float32)
        for i in range(n_mels):
            left, center, right = bins[i], bins[i + 1], bins[i + 2]
            if center == left:
                center += 1
            if right == center:
                right += 1
            for j in range(left, min(center, fb.shape[1])):
                fb[i, j] = (j - left) / float(center - left)
            for j in range(center, min(right, fb.shape[1])):
                fb[i, j] = (right - j) / float(right - center)
        return fb

    def waveform_to_mel(self, waveform: np.ndarray, waveform_sample_rate: int) -> np.ndarray:
        """(channels, samples) -> (1, channels, time, mel) log-mel
        (reference: ops.py:195-204)."""
        waveform = self.resample(waveform.astype(np.float32), waveform_sample_rate)
        mag = self.stft_magnitude(waveform)  # (ch, freq, time)
        mel = np.einsum("mf,cft->cmt", self.mel_filter(), mag)
        mel = np.log(np.clip(mel, 1e-5, None))
        # (ch, mel, time) -> (1, ch, time, mel)
        return np.transpose(mel, (0, 2, 1))[None].astype(np.float32)

    def load_audio_mel(self, path: str) -> np.ndarray:
        """Read a wav file and return (1, ch, time, mel) log-mel."""
        try:
            import soundfile as sf  # type: ignore

            wav, sr = sf.read(path, always_2d=True)
            wav = wav.T.astype(np.float32)
        except ImportError:
            import wave

            with wave.open(path, "rb") as wf:
                sr = wf.getframerate()
                n = wf.getnframes()
                data = np.frombuffer(wf.readframes(n), dtype=np.int16)
                wav = data.reshape(-1, wf.getnchannels()).T.astype(np.float32) / 32768.0
        return self.waveform_to_mel(wav, sr)


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
