"""The flax layers the model is built from, in PyTorch.

flax keeps fp32 parameters and casts them, and the input, to the layer's
compute `dtype` at every call; these do the same. GroupNorm computes in fp32
whatever its input and returns its `out_dtype` (the JAX model's
`norm_dtype`).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dense(nn.Linear):
    """flax nn.Dense: y = x·Wᵀ + b in `dtype`."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv(nn.Conv2d):
    """flax nn.Conv with stride 1 and SAME padding (odd kernels), NCHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, padding=kernel_size // 2)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding=self.padding)


class StridedConv(Conv):
    """flax nn.Conv with stride 2 and XLA SAME padding, which is asymmetric:
    the total padding max((ceil(H/s) − 1)·s + k − H, 0) puts its smaller
    half first (for a 3×3 on an even size: 0 before, 1 after)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = same_pad(x.to(dt), self.kernel_size[0], 2)
        return F.conv2d(x, self.weight.to(dt), self.bias.to(dt), stride=2)


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Pad NCHW `x` as XLA's SAME does for this kernel size and stride."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):   # F.pad order: W first, then H
        total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32 groups, eps 1e-5) computed in fp32, its result rounded
    once to `out_dtype`, as flax's GroupNorm(dtype=norm_dtype) does.

    An input already in `out_dtype` goes through one kernel, which computes
    in fp32 inside (PyTorch's accumulate type) and takes the affine weights
    in the input's dtype: for bf16, a weight that is not a bf16 value (an
    fp32 master) is rounded to one before use."""

    def __init__(self, channels: int, out_dtype: torch.dtype = torch.float32):
        super().__init__(32, channels, eps=1e-5)
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.out_dtype:
            return F.group_norm(x, self.num_groups, self.weight.to(x.dtype),
                                self.bias.to(x.dtype), self.eps)
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(self.out_dtype)
