"""Host image arithmetic of a served request: the bilinear resize at
half-pixel centres (each output value the four taps' float32 sum,
truncated after + 0.5), the uint8 → [-1, 1] scaling and the quantization
of [-1, 1] back to uint8."""

from __future__ import annotations

import numpy as np
import torch


def bilinear_resize(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """HWC uint8 → (oh, ow, C) uint8."""
    h, w, _ = img.shape
    if (h, w) == (oh, ow):
        return img.copy()
    f32 = np.float32
    fy = (np.arange(oh, dtype=f32) + f32(0.5)) * (f32(h) / f32(oh)) - f32(0.5)
    fx = (np.arange(ow, dtype=f32) + f32(0.5)) * (f32(w) / f32(ow)) - f32(0.5)
    y0, x0 = np.floor(fy).astype(np.int64), np.floor(fx).astype(np.int64)
    wy = (fy - y0.astype(f32))[:, None, None]
    wx = (fx - x0.astype(f32))[None, :, None]
    ya, yb = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
    xa, xb = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    one = f32(1)
    f = img.astype(f32)
    v = ((one - wy) * (one - wx) * f[ya][:, xa] + (one - wy) * wx * f[ya][:, xb]
         + wy * (one - wx) * f[yb][:, xa] + wy * wx * f[yb][:, xb])
    return (v + f32(0.5)).astype(np.uint8)


def to_unit(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] → float32 [-1, 1]."""
    return x_u8.float() / 255.0 * 2.0 - 1.0


def quantize(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] → uint8: ((x + 1)/2)·255, clipped to [0, 255], truncated."""
    return ((x + 1.0) / 2.0 * 255.0).clamp(0, 255).to(torch.uint8)
