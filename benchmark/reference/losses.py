"""Image-space losses of the enhancer's composite objective, plainly.

MS-SSIM (Wang et al. 2003): an 11-tap Gaussian window (σ 1.5) as two
"valid" depthwise passes, K1 0.01, K2 0.03, data range 1, the five
standard weights, 2×2 average pooling between scales, contrast-structure
at the coarse scales and luminance × contrast-structure at the last, each
scale's mean over the whole batch, a scale's value clamped at 1e-6 before
its power; scales that the image is too small for are dropped and the
remaining weights renormalised. The angular colour loss: 1 − the batch
mean of Σ⟨x, y⟩ / Σ√((|x|² + ε)(|y|² + ε)) over each image's pixels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _blur(x: torch.Tensor, size: int = 11, sigma: float = 1.5):
    r = torch.arange(size, dtype=torch.float64, device=x.device) - (size - 1) / 2
    g = torch.exp(-(r ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).to(x.dtype)
    C = x.shape[1]
    x = F.conv2d(x, g.view(1, 1, size, 1).expand(C, 1, size, 1), groups=C)
    return F.conv2d(x, g.view(1, 1, 1, size).expand(C, 1, 1, size), groups=C)


def ms_ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """MS-SSIM of NHWC images in [0, 1], a scalar over the batch."""
    H, W = x.shape[1:3]
    usable = 1
    while usable < len(WEIGHTS) and min(H, W) // (2 ** usable) >= 11:
        usable += 1
    w = np.asarray(WEIGHTS[:usable])
    w = w / w.sum()
    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    out = 1.0
    for i, wi in enumerate(w):
        mx, my = _blur(x), _blur(y)
        sx = _blur(x * x) - mx * mx
        sy = _blur(y * y) - my * my
        sxy = _blur(x * y) - mx * my
        cs = (2 * sxy + c2) / (sx + sy + c2)
        if i == len(w) - 1:
            v = ((2 * mx * my + c1) / (mx * mx + my * my + c1) * cs).mean()
        else:
            v = cs.mean()
            x, y = F.avg_pool2d(x, 2), F.avg_pool2d(y, 2)
        out = out * torch.clamp(v, min=1e-6) ** float(np.float32(wi))
    return out


def color_loss(x: torch.Tensor, y: torch.Tensor,
               eps: float = 1e-8) -> torch.Tensor:
    dot = (x * y).sum(-1)
    w = torch.sqrt(((x * x).sum(-1) + eps) * ((y * y).sum(-1) + eps))
    return 1.0 - (dot.sum(dim=(-2, -1)) / w.sum(dim=(-2, -1))).mean()
