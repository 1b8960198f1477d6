"""Output post-processing: grid-artifact reduction on decoded frames.

The port's copy of mlx_video_tpu/postprocess.py: bilateral, gaussian and
unsharp filters, FFT notch removal of the VAE's 8-pixel grid periodicity,
and the strength-blended ``reduce_grid_artifacts``. Host-side numpy and cv2
on decoded uint8 frames.
"""

from __future__ import annotations

import numpy as np


def bilateral_filter(
    image: np.ndarray, d: int = 5, sigma_color: float = 75, sigma_space: float = 75
) -> np.ndarray:
    """Edge-preserving smoothing of one (H, W, C) uint8 frame."""
    try:
        import cv2

        return cv2.bilateralFilter(image, d, sigma_color, sigma_space)
    except ImportError:
        return gaussian_blur(image, kernel_size=3)


def gaussian_blur(image: np.ndarray, kernel_size: int = 3) -> np.ndarray:
    try:
        import cv2

        return cv2.GaussianBlur(image, (kernel_size, kernel_size), 0)
    except ImportError:
        # separable box blur fallback
        k = max(1, kernel_size)
        pad = k // 2
        x = image.astype(np.float32)
        x = np.pad(x, ((pad, pad), (0, 0), (0, 0)), mode="edge")
        x = np.stack([x[i : i + image.shape[0]] for i in range(k)]).mean(0)
        x = np.pad(x, ((0, 0), (pad, pad), (0, 0)), mode="edge")
        x = np.stack([x[:, i : i + image.shape[1]] for i in range(k)]).mean(0)
        return np.clip(x, 0, 255).astype(np.uint8)


def unsharp_mask(
    image: np.ndarray, kernel_size: int = 5, sigma: float = 1.0, amount: float = 1.0
) -> np.ndarray:
    """Sharpen by subtracting a Gaussian-blurred copy."""
    try:
        import cv2

        blurred = cv2.GaussianBlur(image, (kernel_size, kernel_size), sigma)
        sharpened = cv2.addWeighted(image, 1 + amount, blurred, -amount, 0)
        return np.clip(sharpened, 0, 255).astype(np.uint8)
    except ImportError:
        return image


def remove_grid_frequency(frame: np.ndarray, grid_size: int = 8) -> np.ndarray:
    """Notch-filter the grid-periodicity frequencies of one (H, W, C) frame.

    Attenuates a Gaussian neighborhood around every harmonic of the
    ``grid_size``-pixel periodicity (the VAE patch grid) in the 2D spectrum.
    """
    h, w, c = frame.shape
    cy, cx = h // 2, w // 2
    freq_y, freq_x = h // grid_size, w // grid_size

    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    mask = np.ones((h, w), dtype=np.float32)
    for fy in range(-2, 3):
        for fx in range(-2, 3):
            if fy == 0 and fx == 0:
                continue
            y0, x0 = cy + fy * freq_y, cx + fx * freq_x
            if 0 <= y0 < h and 0 <= x0 < w:
                dist2 = (yy - y0) ** 2 + (xx - x0) ** 2
                mask *= 1.0 - 0.9 * np.exp(-dist2 / 4.0)

    out = np.empty_like(frame)
    for ch in range(c):
        spec = np.fft.fftshift(np.fft.fft2(frame[:, :, ch].astype(np.float32)))
        filtered = np.fft.ifft2(np.fft.ifftshift(spec * mask)).real
        out[:, :, ch] = np.clip(filtered, 0, 255).astype(frame.dtype)
    return out


def reduce_grid_artifacts(
    video: np.ndarray, method: str = "bilateral", strength: float = 1.0
) -> np.ndarray:
    """Reduce decode grid artifacts over (F, H, W, C) uint8 video.

    ``strength`` < 1 blends the filtered result with the original.
    """
    if method == "bilateral":
        d = max(3, int(5 * strength))
        sigma = 50 + 50 * strength
        processed = np.stack(
            [bilateral_filter(f, d=d, sigma_color=sigma, sigma_space=sigma) for f in video]
        )
    elif method == "gaussian":
        kernel_size = max(3, int(3 + 4 * strength))
        if kernel_size % 2 == 0:
            kernel_size += 1
        processed = np.stack([gaussian_blur(f, kernel_size=kernel_size) for f in video])
    elif method == "frequency":
        processed = np.stack([remove_grid_frequency(f, grid_size=8) for f in video])
    else:
        raise ValueError(f"Unknown method: {method}")

    if strength < 1.0:
        processed = (strength * processed + (1 - strength) * video).astype(np.uint8)
    return processed
