"""Image quality metrics: PSNR + SSIM (host-side NumPy; a copy of
``mipnerf360_tpu/utils/metrics.py``).

PSNR over the per-pixel mean squared error. Standard SSIM (Wang et al.
2004): 11x11 Gaussian window, sigma 1.5, K1=0.01, K2=0.03, per-channel
averaged.
"""
from __future__ import annotations

import numpy as np


def psnr(img, ref) -> float:
    mse = float(np.mean((np.asarray(img, np.float64)
                         - np.asarray(ref, np.float64)) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _filter2(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' convolution along the two leading (H, W) axes."""
    size = len(k)
    # along H
    out = np.zeros((img.shape[0] - size + 1,) + img.shape[1:], img.dtype)
    for i, kv in enumerate(k):
        out += kv * img[i:i + out.shape[0]]
    # along W
    out2 = np.zeros((out.shape[0], out.shape[1] - size + 1) + out.shape[2:],
                    img.dtype)
    for i, kv in enumerate(k):
        out2 += kv * out[:, i:i + out2.shape[1]]
    return out2


def ssim(img, ref, max_val: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> float:
    """SSIM over [H, W] or [H, W, C] float images in [0, max_val]."""
    x = np.asarray(img, np.float64)
    y = np.asarray(ref, np.float64)
    assert x.shape == y.shape, (x.shape, y.shape)
    if x.ndim == 2:
        x, y = x[..., None], y[..., None]
    assert min(x.shape[0], x.shape[1]) >= kernel_size, x.shape

    k = _gaussian_kernel(kernel_size, sigma)
    mu_x = _filter2(x, k)
    mu_y = _filter2(y, k)
    sigma_x = _filter2(x * x, k) - mu_x**2
    sigma_y = _filter2(y * y, k) - mu_y**2
    sigma_xy = _filter2(x * y, k) - mu_x * mu_y

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return float(np.mean(num / den))
