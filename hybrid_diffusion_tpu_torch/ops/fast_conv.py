"""The U-Net's resampling convolutions, in the exact forms the JAX package runs.

Counterpart of `hybrid_diffusion_tpu/ops/fast_conv.py`. Tensors here are
NCHW with OIHW kernels (the port's inner layout); each OIHW kernel is the
transpose of the JAX package's HWIO kernel, so the same weights give the same
function.

1. `conv_transpose_5x5_s2` is `lax.conv_transpose(..., strides=2, "SAME")`
   with an HWIO correlation kernel, computed as its 4-phase form: each output
   phase is a correlation with the non-zero taps of the kernel (3×3 / 3×2 /
   2×3 / 2×2) under asymmetric padding, and the four phases interleave.
2. `fused_dual_downsample` is a 3×3 plus a 5×5 stride-2 SAME convolution as
   one 5×5 convolution with padding (1, 2) on each axis, the 3×3 kernel
   embedded at the centre of the 5×5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv_transpose_5x5_s2(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(B, Cin, H, W) -> (B, Cout, 2H, 2W), without bias.

    weight: (Cout, Cin, 5, 5), the OIHW form of the JAX HWIO kernel `kt`.
    Phase a of an axis uses taps k[1 - a::2] with padding (1, a) on that axis
    (see the JAX module's tap algebra).
    """
    B, _, H, W = x.shape
    weight = weight.to(x.dtype)

    def phase(a_y: int, a_x: int) -> torch.Tensor:
        k = weight[:, :, (1 - a_y)::2, (1 - a_x)::2]
        return F.conv2d(F.pad(x, (1, a_x, 1, a_y)), k)

    row0 = torch.stack([phase(0, 0), phase(0, 1)], dim=-1)  # (B, C, H, W, 2x)
    row1 = torch.stack([phase(1, 0), phase(1, 1)], dim=-1)
    out = torch.stack([row0, row1], dim=3)                  # (B, C, H, 2y, W, 2x)
    return out.reshape(B, weight.shape[0], 2 * H, 2 * W)


def fused_dual_downsample(x: torch.Tensor, k3: torch.Tensor, b3: torch.Tensor,
                          k5: torch.Tensor, b5: torch.Tensor) -> torch.Tensor:
    """conv3x3(x, stride 2, SAME) + conv5x5(x, stride 2, SAME) as ONE conv.

    Kernels OIHW, biases (Cout,). The kernels and the biases are summed in
    their stored dtype and then cast to x's dtype, as in the JAX package.
    """
    k = (F.pad(k3, (1, 1, 1, 1)) + k5).to(x.dtype)
    bias = (b3 + b5).to(x.dtype)
    return F.conv2d(F.pad(x, (1, 2, 1, 2)), k, bias, stride=2)
