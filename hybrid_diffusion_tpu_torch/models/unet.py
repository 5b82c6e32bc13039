"""DynamicUNet, the two-domain conditional denoiser (inference).

Counterpart of `hybrid_diffusion_tpu/models/unet.py::DynamicUNet`, with the
same topology and parameter names:

  - head: Conv 6 → ch over [cond_image ⊕ y_t];
  - down path: per level, `num_res_blocks` ResBlocks, then a DownSample
    between levels; every output is pushed onto the skip stack;
  - middle: 4 ResBlocks with 8-head spatial attention at the bottleneck;
  - up path: per level only `num_res_blocks` skips are popped (the
    reference's topology) and nearest-resized to h's size;
  - tail: GroupNorm → SiLU → Conv → 3, the conv in fp32.

The forward takes and returns NHWC, like the JAX model; inside it is NCHW.
The domain gates of training (`domain_gates_from_batch`) come with the
training slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import nearest_resize
from .blocks import DownSample, ResBlock, UpSample
from .embeddings import ImageConditionEmbedding, TimeEmbedding
from .layers import Conv, GroupNorm32

NUM_MIDDLE_BLOCKS = 4


class DynamicUNet(nn.Module):
    """6-channel-input conditional U-Net with 4 attention middle blocks."""

    def __init__(self, T: int = 1000, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 2, 2),
                 num_res_blocks: int = 2, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.dtype = dtype
        tdim = ch * 4
        self.time_embedding = TimeEmbedding(T, ch, tdim, dtype)
        self.cond_embedding = ImageConditionEmbedding(ch, tdim, dtype)
        self.head = Conv(6, ch, 3, dtype)

        skip_ch = [ch]
        now_ch = ch
        for i, mult in enumerate(self.ch_mult):
            out_ch = ch * mult
            for b in range(num_res_blocks):
                self.add_module(f"down_{i}_{b}",
                                ResBlock(now_ch, out_ch, tdim, dtype=dtype))
                now_ch = out_ch
                skip_ch.append(now_ch)
            if i != len(self.ch_mult) - 1:
                self.add_module(f"downsample_{i}", DownSample(now_ch, dtype))
                skip_ch.append(now_ch)

        for m in range(NUM_MIDDLE_BLOCKS):
            self.add_module(f"middle_{m}", ResBlock(
                now_ch, now_ch, tdim, attn=True, num_heads=num_heads,
                dtype=dtype))

        for i, mult in reversed(list(enumerate(self.ch_mult))):
            out_ch = ch * mult
            for b in range(num_res_blocks):
                in_ch = now_ch + skip_ch.pop()
                self.add_module(f"up_{i}_{b}",
                                ResBlock(in_ch, out_ch, tdim, dtype=dtype))
                now_ch = out_ch
            if i != 0:
                self.add_module(f"upsample_{i}", UpSample(now_ch, dtype))

        self.tail_norm = GroupNorm32(now_ch)
        self.tail_conv = Conv(now_ch, 3, 3, torch.float32)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond_image: Optional[torch.Tensor] = None,
                context_zero: Union[bool, torch.Tensor] = True) -> torch.Tensor:
        """x: (B, H, W, 6) = concat([cond_image, y_t], -1); t: (B,) int.

        context_zero: True zeroes the condition embedding (the reference's
        effective default); a per-example bool tensor masks it per example,
        as batched classifier-free guidance needs. Returns (B, H, W, 3) fp32.
        """
        B = x.shape[0]
        x = x.permute(0, 3, 1, 2)
        temb = self.time_embedding(t)
        cond = x[:, :3] if cond_image is None else cond_image.permute(0, 3, 1, 2)
        cemb = self.cond_embedding(cond)
        mask = torch.as_tensor(context_zero, device=x.device)
        mask = mask.expand(B).to(cemb.dtype)
        cemb = cemb * (1.0 - mask)[:, None]

        h = self.head(x)
        hs = [h]
        for i in range(len(self.ch_mult)):
            for b in range(self.num_res_blocks):
                h = getattr(self, f"down_{i}_{b}")(h, temb, cemb)
                hs.append(h)
            if i != len(self.ch_mult) - 1:
                h = getattr(self, f"downsample_{i}")(h)
                hs.append(h)

        for m in range(NUM_MIDDLE_BLOCKS):
            h = getattr(self, f"middle_{m}")(h, temb, cemb)

        for i in reversed(range(len(self.ch_mult))):
            for b in range(self.num_res_blocks):
                skip = nearest_resize(hs.pop(), h.shape[2], h.shape[3])
                h = getattr(self, f"up_{i}_{b}")(torch.cat([h, skip], dim=1),
                                                 temb, cemb)
            if i != 0:
                h = getattr(self, f"upsample_{i}")(h)

        h = F.silu(self.tail_norm(h)).to(self.dtype)
        return self.tail_conv(h).permute(0, 2, 3, 1)
