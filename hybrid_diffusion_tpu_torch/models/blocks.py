"""U-Net building blocks.

Counterpart of `hybrid_diffusion_tpu/models/blocks.py`. The JAX blocks are
NHWC; these take NCHW, the port's inner layout (the model converts at its
boundary). Module and parameter names follow the flax ones, so that
`weights.py` maps one onto the other.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import fused_spatial_attention
from ..parallel.collectives import copy_to_model, reduce_from_model
from ..ops.fast_conv import conv_transpose_5x5_s2, fused_dual_downsample
from .layers import Conv, Dense, GroupNorm32


class SpatialSelfAttention(nn.Module):
    """Multi-head self-attention over the H·W tokens: a packed q|k|v
    projection, scaled dot-product attention per head, an output
    projection. Init as the JAX block's (torch.nn.MultiheadAttention's):
    in_proj xavier-uniform, out_proj torch's default kernel, zero biases.

    `attention_fn(q, k, v)` replaces the core (q, k, v) -> out computation
    when set, as the JAX block's field does (e.g.
    `ops.make_ring_attention(mesh)` for token-sharded attention).

    `shard_heads(rank, size, group)` makes the block head-sharded (tensor
    parallelism over the mesh's "model" axis): this rank keeps heads
    [rank·h/size, (rank+1)·h/size), that is rows [q_m; k_m; v_m] of the
    packed (3C, C) in_proj and the matching columns of out_proj, runs the
    attention on its h/size heads, and all-reduces the out-projection's
    partial sums over `group` before adding the out bias once (Megatron's
    f and g conjugates, parallel/collectives.py). Each rank's partial
    product takes the compute dtype's operands and is computed, summed over
    the ranks and biased in fp32, then rounded once, as one process's GEMM
    accumulates in fp32 and rounds once (a bf16 partial rounded on each
    rank moved a flagship step's gradient norm by 5.7e-3 from one
    process's in chip_smoke.py's parallel phase; 2.0e-6 since).
    """

    def __init__(self, channels: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels do not split into "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = channels // num_heads
        self.in_proj = Dense(channels, 3 * channels, dtype)
        self.out_proj = Dense(channels, channels, dtype)
        nn.init.xavier_uniform_(self.in_proj.weight)
        nn.init.zeros_(self.in_proj.bias)
        nn.init.zeros_(self.out_proj.bias)
        self.attention_fn: Optional[Callable] = None
        self.local_heads = num_heads
        self.model_group = None

    @torch.no_grad()
    def shard_heads(self, rank: int, size: int, group) -> None:
        """Keep this rank's heads of the (full) projections, in place."""
        from ..parallel.sharding import HEAD_SHARDS, shard_tensor

        if self.local_heads != self.num_heads:
            raise RuntimeError("the attention block is sharded already")
        if self.num_heads % size:
            raise ValueError(f"{self.num_heads} heads do not split over "
                             f"{size} ranks")
        for name, spec in HEAD_SHARDS.items():
            layer, leaf = name.split(".")
            mod = getattr(self, layer)
            setattr(mod, leaf, nn.Parameter(
                shard_tensor(getattr(mod, leaf).detach(), spec, rank, size)))
        self.local_heads = self.num_heads // size
        self.model_group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        N, heads = H * W, self.local_heads
        tokens = x.flatten(2).transpose(1, 2)                # (B, N, C)
        if self.model_group is not None:
            tokens = copy_to_model(tokens, self.model_group)
        qkv = self.in_proj(tokens)                           # (B, N, 3C')
        # Strided views, no copies: the kernel reads (B, N, h, d) by strides.
        q, k, v = qkv.view(B, N, 3, heads, self.head_dim).unbind(2)
        attend = self.attention_fn or fused_spatial_attention
        out = attend(q, k, v).reshape(B, N, heads * self.head_dim)
        if self.model_group is None:
            out = self.out_proj(out)
        else:
            dt = self.out_proj.dtype
            partial = F.linear(out.to(dt).float(),
                               self.out_proj.weight.to(dt).float())
            out = (reduce_from_model(partial, self.model_group)
                   + self.out_proj.bias.to(dt).float()).to(dt)
        return out.transpose(1, 2).reshape(B, C, H, W)


class ResBlock(nn.Module):
    """GN → SiLU → Conv3 | + temb | + cemb | GN → SiLU → Dropout → Conv3 |
    + shortcut, then, with `attn`, spatial attention that REPLACES h (no
    residual, as in the reference). GroupNorm runs in fp32 and returns
    `norm_dtype` (fp32 by default); its SiLU output is cast to the compute
    dtype.

    Dropout runs only when the caller passes a generator (the model does in
    train mode): where(mask, h/keep, 0), the mask drawn from that generator.
    With `remat` the block's activations are recomputed in the backward
    (torch.utils.checkpoint, the JAX model's nn.remat). The mask is drawn
    before the recomputed region and handed to it, because checkpoint
    replays only the global RNG's state, not an explicit generator's.
    """

    def __init__(self, in_ch: int, out_ch: int, tdim: int, attn: bool = False,
                 num_heads: int = 8, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, remat: bool = False,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_ch = out_ch
        self.dropout = dropout
        self.remat = remat
        self.norm1 = GroupNorm32(in_ch, norm_dtype)
        self.conv1 = Conv(in_ch, out_ch, 3, dtype)
        self.temb_proj = Dense(tdim, out_ch, dtype)
        self.cemb_proj = Dense(tdim, out_ch, dtype)
        self.norm2 = GroupNorm32(out_ch, norm_dtype)
        self.conv2 = Conv(out_ch, out_ch, 3, dtype)
        self.shortcut = Conv(in_ch, out_ch, 1, dtype) if in_ch != out_ch else None
        self.attn = (SpatialSelfAttention(out_ch, num_heads, dtype)
                     if attn else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                cemb: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        keep_mask = None
        if dropout_generator is not None and self.dropout > 0:
            B, _, H, W = x.shape
            keep_mask = torch.rand((B, self.out_ch, H, W), device=x.device,
                                   generator=dropout_generator) >= self.dropout
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._forward, x, temb, cemb, keep_mask,
                              use_reentrant=False)
        return self._forward(x, temb, cemb, keep_mask)

    def _forward(self, x: torch.Tensor, temb: torch.Tensor,
                 cemb: torch.Tensor,
                 keep_mask: Optional[torch.Tensor]) -> torch.Tensor:
        dt = self.dtype
        h = self.conv1(F.silu(self.norm1(x)).to(dt))
        h = h + self.temb_proj(F.silu(temb.to(dt)))[:, :, None, None]
        h = h + self.cemb_proj(F.silu(cemb.to(dt)))[:, :, None, None]
        h = F.silu(self.norm2(h)).to(dt)
        if keep_mask is not None:
            h = torch.where(keep_mask, h / (1.0 - self.dropout), 0.0)
        h = self.conv2(h)
        if self.shortcut is not None:
            x = self.shortcut(x)
        h = h + x
        if self.attn is not None:
            h = self.attn(h)
        return h


def _conv_param(out_ch: int, in_ch: int, k: int) -> nn.Parameter:
    bound = (in_ch * k * k) ** -0.5
    return nn.Parameter(torch.empty(out_ch, in_ch, k, k).uniform_(-bound, bound))


def _bias_param(ch: int, fan_in: int) -> nn.Parameter:
    bound = fan_in ** -0.5
    return nn.Parameter(torch.empty(ch).uniform_(-bound, bound))


class DownSample(nn.Module):
    """Sum of a 3×3 and a 5×5 stride-2 SAME conv, run as one fused 5×5
    (ops/fast_conv.py).

    torch_pad: torch's symmetric stride-2 padding instead (1 for the 3×3, 2
    for the 5×5; XLA's SAME puts (0, 1) and (1, 2)), as two convolutions:
    the two sample positions one pixel apart. For comparisons with the torch
    reference; the shipped weights are SAME-trained.
    """

    def __init__(self, ch: int, dtype: torch.dtype = torch.float32,
                 torch_pad: bool = False):
        super().__init__()
        self.dtype = dtype
        self.torch_pad = torch_pad
        self.k3, self.b3 = _conv_param(ch, ch, 3), _bias_param(ch, ch * 9)
        self.k5, self.b5 = _conv_param(ch, ch, 5), _bias_param(ch, ch * 25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if not self.torch_pad:
            return fused_dual_downsample(x, self.k3, self.b3, self.k5, self.b5)
        a = F.conv2d(x, self.k3.to(x.dtype), stride=2, padding=1)
        b = F.conv2d(x, self.k5.to(x.dtype), stride=2, padding=2)
        return a + b + (self.b3 + self.b5).to(x.dtype)[:, None, None]


class UpSample(nn.Module):
    """ConvTranspose 5×5 stride 2 (SAME, exact 2×) in its 4-phase form, then
    a 3×3 conv.

    torch_pad: torch's `ConvTranspose2d(5, 2, 2, output_padding=1)` instead
    (an lhs-dilated correlation with padding (2, 3); SAME gives the same
    values shifted one pixel). `kt` is the correlation kernel either way: the
    transposed convolution's weight is kt flipped in space, in and out
    swapped.
    """

    def __init__(self, ch: int, dtype: torch.dtype = torch.float32,
                 torch_pad: bool = False):
        super().__init__()
        self.dtype = dtype
        self.torch_pad = torch_pad
        self.kt, self.bt = _conv_param(ch, ch, 5), _bias_param(ch, ch * 25)
        self.c = Conv(ch, ch, 3, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.torch_pad:
            weight = self.kt.to(x.dtype).flip(-2, -1).transpose(0, 1)
            x = F.conv_transpose2d(x, weight, stride=2, padding=2,
                                   output_padding=1)
        else:
            x = conv_transpose_5x5_s2(x, self.kt)
        x = x + self.bt.to(x.dtype)[:, None, None]
        return self.c(x)
