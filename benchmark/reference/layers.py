"""Layers of the plain reference, and the precision of their products.

Every product (convolution, dense layer, attention's two products) takes
its operands through an `Operand`: `FP32` leaves them as they are, so the
product runs in fp32 (TF32 off, `fp32_products()`); `FP8` rounds each
operand to float8 e4m3 with a per-tensor scale first, and in a backward
the gradient reaching it to float8 e5m2 with its own scale. FP8 is the control
of a bf16 configuration: the reference one precision step below it.
Norms, softmax and the elementwise chain stay fp32 in both.

`attention_calls`, when set to a list, records (B, N, heads, head_dim) of
every attention call: the benchmark's attention counts read it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0         # largest finite float8 e4m3fn value
FP8_E5M2_MAX = 57344.0  # and e5m2


class Operand:
    """The identity on an operand: products in fp32."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x.float()


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to `dtype` under a per-tensor scale that maps its largest
    magnitude to `top`, returned in fp32."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8Round(torch.autograd.Function):
    """Forward: the operand in float8 e4m3; backward: the incoming
    gradient in float8 e5m2, each under its own per-tensor scale, as fp8
    training rounds activations, weights and gradients."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad.float(), torch.float8_e5m2, FP8_E5M2_MAX)


class Fp8Operand(Operand):
    """An operand rounded to float8 (its gradient too, _Fp8Round)."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8Round.apply(x.float())


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32's 10-bit mantissa, to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _Tf32Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _tf32(x)

    @staticmethod
    def backward(ctx, grad):
        return _tf32(grad.float())


class Tf32Operand(Operand):
    """An operand (and the gradient reaching it) rounded to TF32: a witness
    of how far a number moves with rounding alone, near fp32."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Tf32Round.apply(x.float())


FP32 = Operand()
FP8 = Fp8Operand()
TF32 = Tf32Operand()

attention_calls: Optional[list] = None


@contextlib.contextmanager
def fp32_products() -> Iterator[None]:
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


class Dense(nn.Linear):
    def __init__(self, fan_in: int, fan_out: int, op: Operand):
        super().__init__(fan_in, fan_out)
        self.op = op

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.op(x), self.op(self.weight), self.bias.float())


class Conv(nn.Conv2d):
    """Stride-1 convolution with symmetric padding k // 2 (odd k)."""

    def __init__(self, cin: int, cout: int, k: int, op: Operand):
        super().__init__(cin, cout, k, padding=k // 2)
        self.op = op

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(self.op(x), self.op(self.weight), self.bias.float(),
                        padding=self.padding)


def same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """XLA's SAME padding of NCHW x for a k×k kernel: the smaller half of
    max((ceil(n/s) − 1)·s + k − n, 0) first, on each spatial axis."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class StridedConv(Conv):
    """Stride-2 convolution with XLA's SAME padding."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = same_pad(x, self.kernel_size[0], 2)
        return F.conv2d(self.op(x), self.op(self.weight), self.bias.float(),
                        stride=2)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm with 32 groups and eps 1e-5, in fp32."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), 32, self.weight, self.bias, self.eps)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              op: Operand) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v over (B, N, heads, d) tensors, in fp32."""
    if attention_calls is not None:
        attention_calls.append(tuple(q.shape))
    scores = torch.einsum("bqhd,bkhd->bhqk", op(q), op(k)) / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", op(probs), op(v))
