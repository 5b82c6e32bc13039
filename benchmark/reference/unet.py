"""The two U-Nets, plainly: DynamicUNet (the two-domain enhancer) and
CFGUNet (the label-conditioned CIFAR-10 model).

Both follow the published models' topology (the reference repository's
`Model.py` and `DiffusionFreeGuidence/ModelCondition.py`, as the program
ports them), NCHW inside and NHWC at the boundary, every product through
the layers' `Operand`. Parameter names are the published ones joined by
".", so that one state_dict loads into the program's modules and these.

Dropout is driven from outside: `keep(shape)` returns the boolean keep
mask of a ResBlock's (B, C_out, H, W) activations, and is called once per
ResBlock in the order the blocks run, before the block computes.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (Conv, Dense, GroupNorm32, Operand, StridedConv,
                     attention, same_pad)

KeepFn = Optional[Callable[[tuple], torch.Tensor]]
NUM_MIDDLE_BLOCKS = 4


class SpatialSelfAttention(nn.Module):
    """Packed q|k|v projection, softmax attention per head, projection."""

    def __init__(self, ch: int, heads: int, op: Operand):
        super().__init__()
        self.heads, self.op = heads, op
        self.in_proj = Dense(ch, 3 * ch, op)
        self.out_proj = Dense(ch, ch, op)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        tokens = x.flatten(2).transpose(1, 2)
        q, k, v = self.in_proj(tokens).view(B, H * W, 3, self.heads,
                                            C // self.heads).unbind(2)
        out = attention(q, k, v, self.op).reshape(B, H * W, C)
        return self.out_proj(out).transpose(1, 2).reshape(B, C, H, W)


class ResBlock(nn.Module):
    """GN → SiLU → conv3 (+ temb, + cemb) → GN → SiLU → dropout → conv3,
    plus the shortcut; with attention, the attention's output replaces h."""

    def __init__(self, cin: int, cout: int, tdim: int, attn: bool,
                 heads: int, dropout: float, op: Operand):
        super().__init__()
        self.dropout = dropout
        self.cout = cout
        self.norm1 = GroupNorm32(cin)
        self.conv1 = Conv(cin, cout, 3, op)
        self.temb_proj = Dense(tdim, cout, op)
        self.cemb_proj = Dense(tdim, cout, op)
        self.norm2 = GroupNorm32(cout)
        self.conv2 = Conv(cout, cout, 3, op)
        self.shortcut = Conv(cin, cout, 1, op) if cin != cout else None
        self.attn = SpatialSelfAttention(cout, heads, op) if attn else None

    def forward(self, x, temb, cemb, keep: KeepFn = None):
        mask = None
        if keep is not None and self.dropout > 0:
            B, _, H, W = x.shape
            mask = keep((B, self.cout, H, W))
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = h + self.cemb_proj(F.silu(cemb))[:, :, None, None]
        h = F.silu(self.norm2(h))
        if mask is not None:
            h = torch.where(mask, h / (1.0 - self.dropout), 0.0)
        h = self.conv2(h)
        h = h + (self.shortcut(x) if self.shortcut is not None else x)
        return self.attn(h) if self.attn is not None else h


class DownSample(nn.Module):
    """A 3×3 and a 5×5 stride-2 SAME convolution, summed: one 5×5
    convolution whose kernel is k5 plus k3 at its centre (the same linear
    map; the counts take the 25 taps a position that it needs)."""

    def __init__(self, ch: int, op: Operand):
        super().__init__()
        self.op = op
        self.k3 = nn.Parameter(torch.empty(ch, ch, 3, 3))
        self.b3 = nn.Parameter(torch.empty(ch))
        self.k5 = nn.Parameter(torch.empty(ch, ch, 5, 5))
        self.b5 = nn.Parameter(torch.empty(ch))

    def forward(self, x):
        kernel = self.k5 + F.pad(self.k3, (1, 1, 1, 1))
        return F.conv2d(self.op(same_pad(x, 5, 2)), self.op(kernel),
                        self.b3 + self.b5, stride=2)


class UpSample(nn.Module):
    """A 5×5 stride-2 SAME transposed convolution with the correlation
    kernel kt (the input dilated by 2, padded (3, 2) on each axis,
    correlated with kt: a transposed convolution with the kernel flipped,
    padding 1, its last row and column cut), then a 3×3 conv."""

    def __init__(self, ch: int, op: Operand):
        super().__init__()
        self.op = op
        self.kt = nn.Parameter(torch.empty(ch, ch, 5, 5))
        self.bt = nn.Parameter(torch.empty(ch))
        self.c = Conv(ch, ch, 3, op)

    def forward(self, x):
        H, W = x.shape[-2:]
        weight = self.op(self.kt).flip(-2, -1).transpose(0, 1)
        h = F.conv_transpose2d(self.op(x), weight, stride=2, padding=1)
        return self.c(h[:, :, :2 * H, :2 * W] + self.bt[:, None, None])


class TimeEmbedding(nn.Module):
    def __init__(self, T: int, d: int, dim: int, op: Operand):
        super().__init__()
        self.table = nn.Parameter(torch.empty(T, d))
        self.dense1 = Dense(d, dim, op)
        self.dense2 = Dense(dim, dim, op)

    def forward(self, t):
        return self.dense2(F.silu(self.dense1(self.table[t.long()])))


class ImageConditionEmbedding(nn.Module):
    """Three stride-2 SAME 3×3 convs, global mean, Dense → SiLU → Dense."""

    def __init__(self, d: int, dim: int, op: Operand):
        super().__init__()
        ch = d // 16
        self.conv1 = StridedConv(3, ch, 3, op)
        self.conv2 = StridedConv(ch, 2 * ch, 3, op)
        self.conv3 = StridedConv(2 * ch, 4 * ch, 3, op)
        self.dense1 = Dense(4 * ch, dim, op)
        self.dense2 = Dense(dim, dim, op)

    def forward(self, image):
        x = self.conv3(self.conv2(self.conv1(image))).mean(dim=(2, 3))
        return self.dense2(F.silu(self.dense1(x)))


class LabelEmbedding(nn.Module):
    """Label table (row 0, the null label, read as zeros), Dense → SiLU →
    Dense."""

    def __init__(self, labels: int, d: int, dim: int, op: Operand):
        super().__init__()
        self.table = nn.Parameter(torch.empty(labels + 1, d))
        self.dense1 = Dense(d, dim, op)
        self.dense2 = Dense(dim, dim, op)

    def forward(self, labels):
        table = torch.cat([torch.zeros_like(self.table[:1]), self.table[1:]])
        return self.dense2(F.silu(self.dense1(table[labels.long()])))


def nearest_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest-neighbour resize at half-pixel centres (an integer upscale
    repeats)."""
    H, W = x.shape[-2:]
    if (H, W) == (h, w):
        return x
    rows = ((torch.arange(h, device=x.device) + 0.5) * H / h).long()
    cols = ((torch.arange(w, device=x.device) + 0.5) * W / w).long()
    return x[:, :, rows][:, :, :, cols]


class DynamicUNet(nn.Module):
    """6-channel conditional U-Net with 4 attention middle blocks; the up
    path pops `num_res_blocks` skips a level, nearest-resized to h."""

    def __init__(self, T: int, ch: int, ch_mult: Sequence[int],
                 num_res_blocks: int, heads: int, dropout: float,
                 op: Operand):
        super().__init__()
        self.ch_mult, self.nrb = tuple(ch_mult), num_res_blocks
        tdim = 4 * ch
        blk = dict(tdim=tdim, heads=heads, dropout=dropout, op=op)
        self.time_embedding = TimeEmbedding(T, ch, tdim, op)
        self.cond_embedding = ImageConditionEmbedding(ch, tdim, op)
        self.head = Conv(6, ch, 3, op)
        skips, now = [ch], ch
        for i, m in enumerate(self.ch_mult):
            for b in range(num_res_blocks):
                self.add_module(f"down_{i}_{b}",
                                ResBlock(now, ch * m, attn=False, **blk))
                now = ch * m
                skips.append(now)
            if i != len(self.ch_mult) - 1:
                self.add_module(f"downsample_{i}", DownSample(now, op))
                skips.append(now)
        for j in range(NUM_MIDDLE_BLOCKS):
            self.add_module(f"middle_{j}", ResBlock(now, now, attn=True, **blk))
        for i, m in reversed(list(enumerate(self.ch_mult))):
            for b in range(num_res_blocks):
                self.add_module(f"up_{i}_{b}", ResBlock(
                    now + skips.pop(), ch * m, attn=False, **blk))
                now = ch * m
            if i != 0:
                self.add_module(f"upsample_{i}", UpSample(now, op))
        self.tail_norm = GroupNorm32(now)
        self.tail_conv = Conv(now, 3, 3, op)

    def forward(self, x6, t, context_zero, keep: KeepFn = None):
        """x6: (B, H, W, 6) = [cond ⊕ y_t]; context_zero: bool or (B,) bool
        (True zeroes the condition embedding). Returns ε (B, H, W, 3)."""
        B = x6.shape[0]
        x = x6.permute(0, 3, 1, 2).float()
        temb = self.time_embedding(t)
        cemb = self.cond_embedding(x[:, :3])
        if isinstance(context_zero, bool):
            zero = x.new_full((B,), float(context_zero))
        else:
            zero = context_zero.to(x.device).float().expand(B)
        cemb = cemb * (1.0 - zero)[:, None]
        h = self.head(x)
        hs = [h]
        for i in range(len(self.ch_mult)):
            for b in range(self.nrb):
                h = getattr(self, f"down_{i}_{b}")(h, temb, cemb, keep)
                hs.append(h)
            if i != len(self.ch_mult) - 1:
                h = getattr(self, f"downsample_{i}")(h)
                hs.append(h)
        for j in range(NUM_MIDDLE_BLOCKS):
            h = getattr(self, f"middle_{j}")(h, temb, cemb, keep)
        for i in reversed(range(len(self.ch_mult))):
            for b in range(self.nrb):
                skip = nearest_resize(hs.pop(), h.shape[2], h.shape[3])
                h = getattr(self, f"up_{i}_{b}")(torch.cat([h, skip], 1),
                                                 temb, cemb, keep)
            if i != 0:
                h = getattr(self, f"upsample_{i}")(h)
        return self.tail_conv(F.silu(self.tail_norm(h))).permute(0, 2, 3, 1)


class CFGUNet(nn.Module):
    """Label-conditioned U-Net with attention in every block but middle_1;
    the up path takes num_res_blocks + 1 blocks a level over every skip."""

    def __init__(self, T: int, num_labels: int, ch: int,
                 ch_mult: Sequence[int], num_res_blocks: int, heads: int,
                 dropout: float, op: Operand):
        super().__init__()
        self.ch_mult, self.nrb = tuple(ch_mult), num_res_blocks
        tdim = 4 * ch
        blk = dict(tdim=tdim, heads=heads, dropout=dropout, op=op)
        self.time_embedding = TimeEmbedding(T, ch, tdim, op)
        self.cond_embedding = LabelEmbedding(num_labels, ch, tdim, op)
        self.head = Conv(3, ch, 3, op)
        skips, now = [ch], ch
        for i, m in enumerate(self.ch_mult):
            for b in range(num_res_blocks):
                self.add_module(f"down_{i}_{b}",
                                ResBlock(now, ch * m, attn=True, **blk))
                now = ch * m
                skips.append(now)
            if i != len(self.ch_mult) - 1:
                self.add_module(f"downsample_{i}", DownSample(now, op))
                skips.append(now)
        self.middle_0 = ResBlock(now, now, attn=True, **blk)
        self.middle_1 = ResBlock(now, now, attn=False, **blk)
        for i, m in reversed(list(enumerate(self.ch_mult))):
            for b in range(num_res_blocks + 1):
                self.add_module(f"up_{i}_{b}", ResBlock(
                    now + skips.pop(), ch * m, attn=True, **blk))
                now = ch * m
            if i != 0:
                self.add_module(f"upsample_{i}", UpSample(now, op))
        self.tail_norm = GroupNorm32(now)
        self.tail_conv = Conv(now, 3, 3, op)

    def forward(self, x, t, labels, keep: KeepFn = None):
        """x: (B, H, W, 3); labels: (B,) int, 0 the null label."""
        temb = self.time_embedding(t)
        cemb = self.cond_embedding(labels)
        h = self.head(x.permute(0, 3, 1, 2).float())
        hs = [h]
        for i in range(len(self.ch_mult)):
            for b in range(self.nrb):
                h = getattr(self, f"down_{i}_{b}")(h, temb, cemb, keep)
                hs.append(h)
            if i != len(self.ch_mult) - 1:
                h = getattr(self, f"downsample_{i}")(h)
                hs.append(h)
        h = self.middle_0(h, temb, cemb, keep)
        h = self.middle_1(h, temb, cemb, keep)
        for i in reversed(range(len(self.ch_mult))):
            for b in range(self.nrb + 1):
                h = getattr(self, f"up_{i}_{b}")(torch.cat([h, hs.pop()], 1),
                                                 temb, cemb, keep)
            if i != 0:
                h = getattr(self, f"upsample_{i}")(h)
        return self.tail_conv(F.silu(self.tail_norm(h))).permute(0, 2, 3, 1)


def build(model: dict, op: Operand, device="cpu") -> nn.Module:
    """The reference model of a configuration's "model" group, its
    parameters left uninitialised on `device` ("meta" for counting)."""
    kind = model["kind"]
    common = dict(T=model["T"], ch=model["channel"],
                  ch_mult=model["channel_mult"],
                  num_res_blocks=model["num_res_blocks"],
                  heads=model["num_heads"], dropout=model["dropout"], op=op)
    with torch.device(device):
        if kind == "DynamicUNet":
            return DynamicUNet(**common)
        if kind == "CFGUNet":
            return CFGUNet(num_labels=model["num_labels"], **common)
    raise ValueError(f"unknown model kind {kind!r}")
