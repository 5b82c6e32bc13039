"""Color-space transforms (numpy, vectorized) used by the metrics suite.

The port's own copy of `hybrid_diffusion_tpu/metrics/color.py` (:1-59).

The reference relies on skimage.color.rgb2lab / rgb2gray
(metrics/metrics.py:303-304); these are the standard sRGB (D65, 2°
observer) conversions reimplemented directly so the metric suite has no
skimage dependency.
"""

from __future__ import annotations

import numpy as np

# D65 reference white (2° observer), matching skimage's default.
_XN, _YN, _ZN = 0.95047, 1.0, 1.08883

_RGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float64,
)


def _srgb_to_linear(rgb: np.ndarray) -> np.ndarray:
    return np.where(
        rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92
    )


def rgb2lab(rgb: np.ndarray) -> np.ndarray:
    """HWC RGB (uint8 or float in [0,1]) → CIELAB float64.

    L ∈ [0, 100], a/b roughly ∈ [-128, 127].
    """
    rgb = np.asarray(rgb)
    if rgb.dtype == np.uint8:
        rgb = rgb.astype(np.float64) / 255.0
    else:
        rgb = rgb.astype(np.float64)
    xyz = _srgb_to_linear(rgb) @ _RGB2XYZ.T
    xyz = xyz / np.array([_XN, _YN, _ZN])

    eps = 0.008856451679035631  # (6/29)^3
    kappa = 7.787037037037035   # (29/6)^2 / 3 / 29 * 841/108... = 841/108
    f = np.where(xyz > eps, np.cbrt(xyz), kappa * xyz + 16.0 / 116.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, b], axis=-1)


def rgb2gray(rgb: np.ndarray) -> np.ndarray:
    """HWC RGB → luma float in [0,1] (skimage's ITU-R 601-7 coefficients)."""
    rgb = np.asarray(rgb)
    if rgb.dtype == np.uint8:
        rgb = rgb.astype(np.float64) / 255.0
    return rgb[..., 0] * 0.2125 + rgb[..., 1] * 0.7154 + rgb[..., 2] * 0.0721
