"""Counterpart of `hybrid_diffusion_tpu/train/step.py::normalize_uint8`.
(The train step itself comes with the training slice.)"""

from __future__ import annotations

import torch


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1], on x's device (so the copy to the
    card moves 1 byte a pixel)."""
    return x.to(torch.float32) / 255.0 * 2.0 - 1.0
