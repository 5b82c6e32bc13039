"""Nearest-neighbour spatial resize for skip-connection shape repair.

Counterpart of `hybrid_diffusion_tpu/ops/resize.py`, on NCHW tensors. An
integer upscale is a repeat; any other size samples the source at the
half-pixel centres, as `jax.image.resize(..., "nearest")` does
(`nearest-exact` in PyTorch's terms).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nearest_resize(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Resize NCHW `x` to (height, width) with nearest-neighbour sampling."""
    H, W = x.shape[-2:]
    if H == height and W == width:
        return x
    if height % H == 0 and width % W == 0:
        x = x.repeat_interleave(height // H, dim=-2)
        return x.repeat_interleave(width // W, dim=-1)
    return F.interpolate(x, size=(height, width), mode="nearest-exact")
