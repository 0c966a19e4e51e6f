"""PSNR / SSIM for stitched-inference quality reporting (a copy of
orbit2_tpu/utils/image_metrics.py; numpy and scipy only).

Replaces the reference's skimage.metrics calls (reference
utils/visualize.py:369-372; skimage is not a dependency). SSIM follows
the standard Wang et al. formulation with skimage's defaults: 7x7 uniform
window, C1=(0.01 L)^2, C2=(0.03 L)^2, unbiased covariance normalization.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(pred: np.ndarray, target: np.ndarray, data_range: float | None = None) -> float:
    pred = np.asarray(pred, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    if data_range is None:
        data_range = target.max() - target.min()
    mse = np.mean((pred - target) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def ssim(pred: np.ndarray, target: np.ndarray, data_range: float | None = None,
         win_size: int = 7) -> float:
    pred = np.asarray(pred, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    if data_range is None:
        data_range = target.max() - target.min()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    filt = lambda a: uniform_filter(a, size=win_size)
    np_ = win_size ** pred.ndim
    cov_norm = np_ / (np_ - 1)

    ux, uy = filt(pred), filt(target)
    uxx, uyy, uxy = filt(pred * pred), filt(target * target), filt(pred * target)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux**2 + uy**2 + c1) * (vx + vy + c2)
    )
    pad = (win_size - 1) // 2
    interior = s[tuple(slice(pad, d - pad) for d in s.shape)]
    return float(interior.mean())
