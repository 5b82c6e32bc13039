"""SSIM and MS-SSIM. Counterpart of `hybrid_diffusion_tpu/losses/ms_ssim.py`.

11-tap Gaussian window (σ 1.5) applied as two depthwise 1-D "valid" convs,
K1 0.01, K2 0.03, the five standard scale weights, 2×2 average pooling
between scales, contrast-structure terms at the coarse scales and
luminance·contrast-structure at the last. The number of scales adapts to
the image: scale k needs min(H, W) / 2^k ≥ 11, and a smaller image uses a
renormalized prefix of the weights (256²: all 5 scales; 32²: 2).
Inputs are NHWC, as in the JAX package. With a process `group` (the mesh's
"data" group) each scale's batch mean is taken over the group's global
batch (parallel/collectives.py::group_sum), as the JAX function's mean over
a sharded batch is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.collectives import group_sum, size

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_kernel1d(size: int, sigma: float, device=None,
                       dtype=torch.float32) -> torch.Tensor:
    """The normalized window, computed in float64 on `device` (no copy from
    the host, which would wait for the card)."""
    x = torch.arange(size, dtype=torch.float64, device=device) - (size - 1) / 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).to(dtype)


def _gaussian_blur(x: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Depthwise separable Gaussian blur, "valid" padding, NCHW."""
    C = x.shape[1]
    k = _gaussian_kernel1d(size, sigma, x.device, x.dtype)
    x = F.conv2d(x, k.view(1, 1, size, 1).expand(C, 1, size, 1), groups=C)
    return F.conv2d(x, k.view(1, 1, 1, size).expand(C, 1, 1, size), groups=C)


def _ssim_components(x, y, data_range, window_size, sigma, k1, k2):
    """(luminance·cs map, cs map) of NCHW x, y."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    blur = lambda a: _gaussian_blur(a, window_size, sigma)
    mu_x, mu_y = blur(x), blur(y)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = blur(x * x) - mu_xx
    sigma_y = blur(y * y) - mu_yy
    sigma_xy = blur(x * y) - mu_xy
    cs = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    lum = (2 * mu_xy + c1) / (mu_xx + mu_yy + c1)
    return lum * cs, cs


def _mean(m: torch.Tensor, per_example: bool, group=None) -> torch.Tensor:
    if per_example:
        return m.flatten(1).mean(dim=1)
    if group is None:
        return m.mean()
    return group_sum(m.sum(), group) / (m.numel() * size(group))


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
            window_size: int = 11, sigma: float = 1.5,
            weights=MS_SSIM_WEIGHTS, per_example: bool = False,
            group=None) -> torch.Tensor:
    """MS-SSIM of NHWC images: a scalar over the batch (each scale's mean
    taken over the whole batch, as the JAX function; over the global batch
    of `group`), or with `per_example` one value per image, (B,)."""
    H, W = x.shape[1], x.shape[2]
    usable = 1
    while usable < len(weights) and min(H, W) // (2 ** usable) >= window_size:
        usable += 1
    if usable < len(weights):
        w = np.asarray(weights[:usable])
        weights = tuple(w / w.sum())
    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    levels = len(weights)
    vals = []
    for i in range(levels):
        s, cs = _ssim_components(x, y, data_range, window_size, sigma,
                                 0.01, 0.03)
        if i == levels - 1:
            vals.append(_mean(s, per_example, group))
        else:
            vals.append(_mean(cs, per_example, group))
            x, y = F.avg_pool2d(x, 2), F.avg_pool2d(y, 2)
    # Clamped: a tiny negative under a fractional power is NaN.
    out = 1.0
    for v, w in zip(vals, weights):
        out = out * torch.clamp(v, min=1e-6) ** float(np.float32(w))
    return out


def ms_ssim_loss(pred: torch.Tensor, target: torch.Tensor,
                 data_range: float = 1.0, per_example: bool = False,
                 group=None) -> torch.Tensor:
    """1 − MS-SSIM."""
    return 1.0 - ms_ssim(pred, target, data_range=data_range,
                         per_example=per_example, group=group)
