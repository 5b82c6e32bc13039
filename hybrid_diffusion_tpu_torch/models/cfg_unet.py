"""CFGUNet, the label-conditioned U-Net of the classifier-free-guidance
CIFAR-10 subsystem.

Counterpart of `hybrid_diffusion_tpu/models/cfg_unet.py::CFGUNet`, with the
same topology and parameter names:

  - head: Conv 3 → ch;
  - down path: per level, `num_res_blocks` ResBlocks, each with spatial
    attention, then a DownSample between levels; every output is pushed
    onto the skip stack;
  - middle: [ResBlock(attn=True), ResBlock(attn=False)];
  - up path: per level `num_res_blocks + 1` ResBlocks, each over
    [h ⊕ the popped skip] (every skip is consumed and the shapes match),
    then an UpSample between levels;
  - tail: GroupNorm → SiLU → Conv → 3, all in fp32.

The time embedding goes to every block's `temb_proj`, the label embedding
(label 0 = unconditional) to its `cemb_proj`. The forward takes and returns
NHWC, like the JAX model; inside it is NCHW. Every attention goes through
`ops/attention.py::fused_spatial_attention`: on the card the hand-written
kernel, on the CPU its plain version (the JAX model's `_xla_attention`).

Init follows the JAX model: torch's defaults, except the head
(xavier-uniform, zero bias), the tail conv (xavier-uniform with gain 1e-5,
zero bias), the attention projections (blocks.py) and the label table
(N(0, 1), embeddings.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import DownSample, ResBlock, UpSample
from .embeddings import LabelEmbedding, TimeEmbedding
from .layers import Conv, GroupNorm32


class CFGUNet(nn.Module):
    """Label-conditioned ε-predictor for 3-channel images."""

    def __init__(self, T: int = 500, num_labels: int = 10, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 2, 2),
                 num_res_blocks: int = 2, dropout: float = 0.15,
                 num_heads: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.dtype = dtype
        self.dropout = dropout
        tdim = ch * 4
        block = dict(tdim=tdim, dtype=dtype, dropout=dropout,
                     num_heads=num_heads)
        self.time_embedding = TimeEmbedding(T, ch, tdim, dtype)
        self.cond_embedding = LabelEmbedding(num_labels, ch, tdim, dtype)
        self.head = Conv(3, ch, 3, dtype)
        nn.init.xavier_uniform_(self.head.weight)
        nn.init.zeros_(self.head.bias)

        skip_ch = [ch]
        now_ch = ch
        for i, mult in enumerate(self.ch_mult):
            out_ch = ch * mult
            for b in range(num_res_blocks):
                self.add_module(f"down_{i}_{b}", ResBlock(
                    now_ch, out_ch, attn=True, **block))
                now_ch = out_ch
                skip_ch.append(now_ch)
            if i != len(self.ch_mult) - 1:
                self.add_module(f"downsample_{i}", DownSample(now_ch, dtype))
                skip_ch.append(now_ch)

        self.middle_0 = ResBlock(now_ch, now_ch, attn=True, **block)
        self.middle_1 = ResBlock(now_ch, now_ch, attn=False, **block)

        for i, mult in reversed(list(enumerate(self.ch_mult))):
            out_ch = ch * mult
            for b in range(num_res_blocks + 1):
                self.add_module(f"up_{i}_{b}", ResBlock(
                    now_ch + skip_ch.pop(), out_ch, attn=True, **block))
                now_ch = out_ch
            if i != 0:
                self.add_module(f"upsample_{i}", UpSample(now_ch, dtype))

        self.tail_norm = GroupNorm32(now_ch)
        self.tail_conv = Conv(now_ch, 3, 3, torch.float32)
        nn.init.xavier_uniform_(self.tail_conv.weight, gain=1e-5)
        nn.init.zeros_(self.tail_conv.bias)

    def forward(self, x: torch.Tensor, t: torch.Tensor, labels: torch.Tensor,
                *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, H, W, 3) in [-1, 1]; t: (B,) int; labels: (B,) int, 0 the
        unconditional slot. train: dropout on, its masks drawn from
        `generator` (on x's device). Returns (B, H, W, 3) fp32."""
        drop_gen = None
        if train and self.dropout > 0:
            if generator is None:
                raise ValueError("train=True with dropout needs a generator "
                                 "for the dropout masks")
            drop_gen = generator
        temb = self.time_embedding(t)
        cemb = self.cond_embedding(labels)

        h = self.head(x.permute(0, 3, 1, 2))
        hs = [h]
        for i in range(len(self.ch_mult)):
            for b in range(self.num_res_blocks):
                h = getattr(self, f"down_{i}_{b}")(h, temb, cemb, drop_gen)
                hs.append(h)
            if i != len(self.ch_mult) - 1:
                h = getattr(self, f"downsample_{i}")(h)
                hs.append(h)

        h = self.middle_0(h, temb, cemb, drop_gen)
        h = self.middle_1(h, temb, cemb, drop_gen)

        for i in reversed(range(len(self.ch_mult))):
            for b in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_{b}")(
                    torch.cat([h, hs.pop()], dim=1), temb, cemb, drop_gen)
            if i != 0:
                h = getattr(self, f"upsample_{i}")(h)

        h = F.silu(self.tail_norm(h))
        return self.tail_conv(h).permute(0, 2, 3, 1)
