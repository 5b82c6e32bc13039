"""Charbonnier loss. Counterpart of `hybrid_diffusion_tpu/losses/charbonnier.py`:
mean over elements of sqrt(diff² + ε²) − ε."""

from __future__ import annotations

import torch


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-3, per_example: bool = False
                     ) -> torch.Tensor:
    """A scalar, or with `per_example` one value per leading index (B,)."""
    diff = pred - target
    value = torch.sqrt(diff * diff + eps * eps) - eps
    if per_example:
        return value.flatten(1).mean(dim=1)
    return value.mean()
