"""SSIM and PSNR as the reference's skimage calls compute them
(counterpart of shineon_tpu/utils/metrics.py; reference
calculate_metrics.py:102-107): a 7x7 uniform window, K1 0.01, K2 0.03, the
sample covariance (N / (N - 1)), per-channel SSIM averaged over channels,
the window's edge cropped."""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def structural_similarity(im1: np.ndarray, im2: np.ndarray, data_range: float | None = None,
                          multichannel: bool = False, win_size: int = 7, K1: float = 0.01,
                          K2: float = 0.03) -> float:
    """SSIM of two (H, W) images, or (H, W, C) with ``multichannel``."""
    im1 = np.asarray(im1, np.float64)
    im2 = np.asarray(im2, np.float64)
    if im1.shape != im2.shape:
        raise ValueError(f"shape mismatch: {im1.shape} vs {im2.shape}")
    if multichannel or (im1.ndim == 3 and im1.shape[-1] in (3, 4)):
        return float(np.mean([
            structural_similarity(im1[..., c], im2[..., c], data_range=data_range,
                                  win_size=win_size, K1=K1, K2=K2)
            for c in range(im1.shape[-1])]))
    if data_range is None:
        data_range = im1.max() - im1.min()
    if data_range == 0:
        data_range = 1.0
    np_ = win_size ** im1.ndim
    cov_norm = np_ / (np_ - 1)

    def f(x):
        return uniform_filter(x, size=win_size)

    ux, uy = f(im1), f(im2)
    vx = cov_norm * (f(im1 * im1) - ux * ux)
    vy = cov_norm * (f(im2 * im2) - uy * uy)
    vxy = cov_norm * (f(im1 * im2) - ux * uy)
    c1, c2 = (K1 * data_range) ** 2, (K2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return float(s[tuple(slice(pad, n - pad) for n in s.shape)].mean())


def peak_signal_noise_ratio(image_true: np.ndarray, image_test: np.ndarray,
                            data_range: float | None = None) -> float:
    image_true = np.asarray(image_true, np.float64)
    image_test = np.asarray(image_test, np.float64)
    if data_range is None:
        data_range = image_true.max() - image_true.min()
    mse = np.mean((image_true - image_test) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10((data_range ** 2) / mse))

