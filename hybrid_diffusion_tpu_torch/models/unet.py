"""DynamicUNet, the two-domain conditional denoiser.

Counterpart of `hybrid_diffusion_tpu/models/unet.py::DynamicUNet`, with the
same topology and parameter names:

  - head: Conv 6 → ch over [cond_image ⊕ y_t];
  - down path: per level, `num_res_blocks` ResBlocks, then a DownSample
    between levels; every output is pushed onto the skip stack;
  - middle: 4 ResBlocks with 8-head spatial attention at the bottleneck;
  - up path: per level only `num_res_blocks` skips are popped (the
    reference's topology) and nearest-resized to h's size;
  - tail: GroupNorm → SiLU → Conv → 3, the conv in fp32.

Every GroupNorm computes in fp32 and returns `norm_dtype`: fp32 by default,
as in the JAX model; the bench asks for bf16, as the JAX bench does.

The forward takes and returns NHWC, like the JAX model; inside it is NCHW.
`train=True` turns dropout on, its masks drawn from the caller's generator.
Training routes the middle blocks by domain with `domain_gates_from_batch`.
`torch_pad` gives the resampling convolutions torch's padding instead of
XLA's SAME (blocks.py), for comparisons with the torch reference; it is off
by default, as in the JAX model.

Init follows the JAX model (`models/torch_init.py` there): torch's default
kaiming-uniform kernels and U(±1/√fan_in) biases everywhere, except the
head (xavier-uniform, zero bias), the tail conv (xavier-uniform with gain
1e-5, zero bias) and the attention projections (blocks.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import nearest_resize
from ..parallel.collectives import all_reduce_, size
from .blocks import DownSample, ResBlock, UpSample
from .embeddings import ImageConditionEmbedding, TimeEmbedding
from .layers import Conv, GroupNorm32

NUM_MIDDLE_BLOCKS = 4


def domain_gates_from_batch(cond_image: torch.Tensor,
                            group=None) -> torch.Tensor:
    """Per-middle-block gradient gates from the batch's colour: float32 (4,)
    of 0/1, gate i == 1 when middle block i trains on this batch.

    cond_image: (B, H, W, 3) RGB, any range. The batch is underwater when
    its mean blue exceeds its mean red: then the even blocks train, else the
    odd ones. With a process `group` (the mesh's "data" group) the means
    are the global batch's, so every rank gates the same blocks.
    """
    if group is None:
        red = cond_image[..., 0].mean()
        blue = cond_image[..., 2].mean()
    else:
        sums = torch.stack([cond_image[..., 0].sum(), cond_image[..., 2].sum()])
        red, blue = (all_reduce_(sums, group)
                     / (cond_image[..., 0].numel() * size(group))).unbind()
    is_underwater = (blue > red).float()
    even = (torch.arange(NUM_MIDDLE_BLOCKS, device=cond_image.device) % 2
            == 0).float()
    return is_underwater * even + (1.0 - is_underwater) * (1.0 - even)


class DynamicUNet(nn.Module):
    """6-channel-input conditional U-Net with 4 attention middle blocks."""

    def __init__(self, T: int = 1000, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 2, 2),
                 num_res_blocks: int = 2, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 remat: bool = False, torch_pad: bool = False,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.dtype = dtype
        self.dropout = dropout
        tdim = ch * 4
        block = dict(tdim=tdim, dtype=dtype, dropout=dropout, remat=remat,
                     norm_dtype=norm_dtype)
        self.time_embedding = TimeEmbedding(T, ch, tdim, dtype)
        self.cond_embedding = ImageConditionEmbedding(ch, tdim, dtype)
        self.head = Conv(6, ch, 3, dtype)
        nn.init.xavier_uniform_(self.head.weight)
        nn.init.zeros_(self.head.bias)

        skip_ch = [ch]
        now_ch = ch
        for i, mult in enumerate(self.ch_mult):
            out_ch = ch * mult
            for b in range(num_res_blocks):
                self.add_module(f"down_{i}_{b}",
                                ResBlock(now_ch, out_ch, **block))
                now_ch = out_ch
                skip_ch.append(now_ch)
            if i != len(self.ch_mult) - 1:
                self.add_module(f"downsample_{i}",
                                DownSample(now_ch, dtype, torch_pad))
                skip_ch.append(now_ch)

        for m in range(NUM_MIDDLE_BLOCKS):
            self.add_module(f"middle_{m}", ResBlock(
                now_ch, now_ch, attn=True, num_heads=num_heads, **block))

        for i, mult in reversed(list(enumerate(self.ch_mult))):
            out_ch = ch * mult
            for b in range(num_res_blocks):
                in_ch = now_ch + skip_ch.pop()
                self.add_module(f"up_{i}_{b}",
                                ResBlock(in_ch, out_ch, **block))
                now_ch = out_ch
            if i != 0:
                self.add_module(f"upsample_{i}",
                                UpSample(now_ch, dtype, torch_pad))

        self.tail_norm = GroupNorm32(now_ch, norm_dtype)
        self.tail_conv = Conv(now_ch, 3, 3, torch.float32)
        nn.init.xavier_uniform_(self.tail_conv.weight, gain=1e-5)
        nn.init.zeros_(self.tail_conv.bias)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond_image: Optional[torch.Tensor] = None,
                context_zero: Union[bool, torch.Tensor] = True, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, H, W, 6) = concat([cond_image, y_t], -1); t: (B,) int.

        context_zero: True zeroes the condition embedding (the reference's
        effective default); a per-example bool tensor masks it per example,
        as batched classifier-free guidance needs. train: dropout on, its
        masks drawn from `generator` (on x's device). Returns (B, H, W, 3)
        fp32.
        """
        drop_gen = None
        if train and self.dropout > 0:
            if generator is None:
                raise ValueError("train=True with dropout needs a generator "
                                 "for the dropout masks")
            drop_gen = generator
        B = x.shape[0]
        x = x.permute(0, 3, 1, 2)
        temb = self.time_embedding(t)
        cond = x[:, :3] if cond_image is None else cond_image.permute(0, 3, 1, 2)
        cemb = self.cond_embedding(cond)
        if isinstance(context_zero, bool):    # no host-to-card copy
            mask = cemb.new_full((B,), float(context_zero))
        else:
            mask = torch.as_tensor(context_zero, device=x.device)
            mask = mask.expand(B).to(cemb.dtype)
        cemb = cemb * (1.0 - mask)[:, None]

        h = self.head(x)
        hs = [h]
        for i in range(len(self.ch_mult)):
            for b in range(self.num_res_blocks):
                h = getattr(self, f"down_{i}_{b}")(h, temb, cemb, drop_gen)
                hs.append(h)
            if i != len(self.ch_mult) - 1:
                h = getattr(self, f"downsample_{i}")(h)
                hs.append(h)

        for m in range(NUM_MIDDLE_BLOCKS):
            h = getattr(self, f"middle_{m}")(h, temb, cemb, drop_gen)

        for i in reversed(range(len(self.ch_mult))):
            for b in range(self.num_res_blocks):
                skip = nearest_resize(hs.pop(), h.shape[2], h.shape[3])
                h = getattr(self, f"up_{i}_{b}")(torch.cat([h, skip], dim=1),
                                                 temb, cemb, drop_gen)
            if i != 0:
                h = getattr(self, f"upsample_{i}")(h)

        h = F.silu(self.tail_norm(h)).to(self.dtype)
        return self.tail_conv(h).permute(0, 2, 3, 1)
