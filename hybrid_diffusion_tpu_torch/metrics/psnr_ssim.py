"""PSNR and SSIM with skimage-compatible semantics.

The port's own copy of `hybrid_diffusion_tpu/metrics/psnr_ssim.py` (:1-67).

The reference evaluates with skimage.metrics.peak_signal_noise_ratio and
structural_similarity(channel_axis=2, data_range=255)
(utils/rotinas.py:922-926). skimage's SSIM default differs from the
Wang-et-al Gaussian form used by the loss (losses/ms_ssim.py): uniform
7×7 window and unbiased (N/(N−1)) covariance normalization — reproduced
here so evaluation numbers are comparable with the reference's reports.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(gt: np.ndarray, pred: np.ndarray, data_range: float = 255.0) -> float:
    gt = np.asarray(gt, np.float64)
    pred = np.asarray(pred, np.float64)
    mse = np.mean((gt - pred) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _ssim_single(x, y, data_range, win_size, k1, k2):
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    filt = lambda a: uniform_filter(a, size=win_size, mode="reflect")
    NP = win_size * win_size
    cov_norm = NP / (NP - 1)  # skimage's unbiased covariance estimate
    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux**2 + uy**2 + c1) * (vx + vy + c2)
    )
    # skimage crops the filter's edge effects before averaging.
    pad = (win_size - 1) // 2
    return s[pad:-pad, pad:-pad].mean() if pad else s.mean()


def ssim_index(
    gt: np.ndarray,
    pred: np.ndarray,
    data_range: float = 255.0,
    win_size: int = 7,
    channel_axis: int | None = 2,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Mean SSIM; with channel_axis set, channels are averaged (skimage)."""
    gt = np.asarray(gt)
    pred = np.asarray(pred)
    if channel_axis is None or gt.ndim == 2:
        return float(_ssim_single(gt, pred, data_range, win_size, k1, k2))
    gt = np.moveaxis(gt, channel_axis, -1)
    pred = np.moveaxis(pred, channel_axis, -1)
    vals = [
        _ssim_single(gt[..., c], pred[..., c], data_range, win_size, k1, k2)
        for c in range(gt.shape[-1])
    ]
    return float(np.mean(vals))
