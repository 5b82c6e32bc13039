"""Angular colour loss. Counterpart of `hybrid_diffusion_tpu/losses/color.py`.

Per image, Σ⟨x,y⟩ / Σ√((|x|²+ε)(|y|²+ε)) over pixels: the mean per-pixel
cosine of the colour vectors weighted by the product of their norms (so a
dark pixel, which has no angle, weighs nothing and the gradients stay
bounded). Not the plain mean cosine, and not `F.cosine_similarity`.
"""

from __future__ import annotations

import torch


def angular_color_loss(pred: torch.Tensor, target: torch.Tensor,
                       eps: float = 1e-8, per_example: bool = False
                       ) -> torch.Tensor:
    """pred, target: (B, H, W, C) NHWC. 1 − the batch mean of the per-image
    ratio, or with `per_example` 1 − each image's ratio, (B,)."""
    dot = (pred * target).sum(dim=-1)
    nx = (pred * pred).sum(dim=-1)
    ny = (target * target).sum(dim=-1)
    w = torch.sqrt((nx + eps) * (ny + eps))
    ratio = dot.sum(dim=(-2, -1)) / w.sum(dim=(-2, -1))
    if per_example:
        return 1.0 - ratio
    return 1.0 - ratio.mean()
