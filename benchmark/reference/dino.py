"""The DINO perceptual loss, plainly: a DINOv2-style ViT-S/14 (Oquab et
al. 2023, arXiv:2304.07193) in fp32, its 12 blocks' outputs and the final
norm's matched by smooth-L1 (β 1), a mean per feature, summed.

Images in [-1, 1], NHWC, are mapped to [0, 1], normalised with the
ImageNet mean and deviation, centre-cropped to a multiple of the patch,
cut into patches; the class token is prepended and the position table
(a square grid of `num_positions − 1`) is resized to the patch grid with
the Keys cubic (a = −0.5, widened when it shrinks, each column summed to
one). Blocks are pre-norm with LayerScale and an exact GELU; LayerNorm's
eps is 1e-6. Parameter names are the program's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dense, Operand, attention

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of a Keys-cubic resize along one axis."""
    inv = np.float32(n_in / n_out)
    scale = max(inv, np.float32(1.0))
    centre = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    x = np.abs(centre[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)


class MHA(nn.Module):
    def __init__(self, dim: int, heads: int, op: Operand):
        super().__init__()
        self.heads, self.op = heads, op
        self.query = Dense(dim, dim, op)
        self.key = Dense(dim, dim, op)
        self.value = Dense(dim, dim, op)
        self.out = Dense(dim, dim, op)

    def forward(self, x):
        B, N, D = x.shape
        q, k, v = (p(x).view(B, N, self.heads, D // self.heads)
                   for p in (self.query, self.key, self.value))
        return self.out(attention(q, k, v, self.op).reshape(B, N, D))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int, op: Operand):
        super().__init__()
        self.gamma_1 = nn.Parameter(torch.empty(dim))
        self.gamma_2 = nn.Parameter(torch.empty(dim))
        self.norm1 = LayerNorm(dim)
        self.attn = MHA(dim, heads, op)
        self.norm2 = LayerNorm(dim)
        self.fc1 = Dense(dim, dim * mlp_ratio, op)
        self.fc2 = Dense(dim * mlp_ratio, dim, op)

    def forward(self, x):
        x = x + self.gamma_1 * self.attn(self.norm1(x))
        return x + self.gamma_2 * self.fc2(F.gelu(self.fc1(self.norm2(x))))


class ViT(nn.Module):
    def __init__(self, patch_size: int, dim: int, depth: int, num_heads: int,
                 mlp_ratio: int, num_positions: int, op: Operand):
        super().__init__()
        self.patch, self.depth, self.op = patch_size, depth, op
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, num_positions, dim))
        for i in range(depth):
            self.add_module(f"block_{i}", Block(dim, num_heads, mlp_ratio, op))
        self.norm = LayerNorm(dim)

    def pos(self, gh: int, gw: int) -> torch.Tensor:
        side = int(round((self.pos_embed.shape[1] - 1) ** 0.5))
        grid = self.pos_embed[:, 1:].reshape(1, side, side, -1)
        if gh != side:
            wh = torch.from_numpy(cubic_resize_matrix(side, gh)).to(grid.device)
            grid = torch.einsum("bhwd,hH->bHwd", grid, wh)
        if gw != side:
            ww = torch.from_numpy(cubic_resize_matrix(side, gw)).to(grid.device)
            grid = torch.einsum("bhwd,wW->bhWd", grid, ww)
        return torch.cat([self.pos_embed[:, :1], grid.reshape(1, gh * gw, -1)],
                         dim=1)

    def forward(self, x):
        B, H, W, _ = x.shape
        gh, gw = H // self.patch, W // self.patch
        x = F.conv2d(self.op(x.permute(0, 3, 1, 2)),
                     self.op(self.patch_embed.weight), self.patch_embed.bias,
                     stride=self.patch)
        x = torch.cat([self.cls_token.expand(B, -1, -1),
                       x.flatten(2).transpose(1, 2)], dim=1) + self.pos(gh, gw)
        feats = []
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
            feats.append(x)
        return feats + [self.norm(x)]


def build(dino: dict, op: Operand, device) -> ViT:
    with torch.device(device):
        return ViT(dino["patch_size"], dino["dim"], dino["depth"],
                   dino["num_heads"], dino["mlp_ratio"],
                   dino["num_positions"], op)


def features(vit: ViT, images: torch.Tensor) -> list[torch.Tensor]:
    mean = torch.tensor(MEAN, device=images.device)
    std = torch.tensor(STD, device=images.device)
    x = ((images + 1.0) / 2.0 - mean) / std
    _, H, W, _ = x.shape
    p = vit.patch
    nh, nw = (H // p) * p, (W // p) * p
    top, left = (H - nh) // 2, (W - nw) // 2
    return vit(x[:, top: top + nh, left: left + nw, :])


def dino_loss(vit: ViT, pred: torch.Tensor, target: torch.Tensor
              ) -> torch.Tensor:
    fp = features(vit, pred)
    with torch.no_grad():
        ft = features(vit, target)
    loss = 0.0
    for a, b in zip(fp, ft):
        loss = loss + F.smooth_l1_loss(a, b, beta=1.0)
    return loss
