"""Perceptual losses: DINO (a DINOv2-style ViT-S/14) and the VGG, alex and
squeeze feature taps.

Counterpart of `hybrid_diffusion_tpu/losses/perceptual.py`: the DINO part
(`center_crop_to_multiple`, `ViTBlock`, `ViTSmall`, `_interpolate_pos_embed`,
`DinoPerceptualLoss`) and the VGG part (`VGG_CFGS`, `VGG_DEFAULT_TAPS`, the
torchvision-ordered VGG, AlexNet and SqueezeNet 1.1 feature stacks,
`VGGPerceptualLoss`). Module and parameter names follow the flax ones, so
that `weights.py` carries a flax parameter tree across in both directions.

Without a weights file an extractor runs with a fixed random init drawn
from a seeded generator with flax's distributions (lecun-normal kernels,
zero biases, LayerScale gammas 1, `cls_token` 0, `pos_embed` N(0, 0.02); the
VGG BatchNorm's scale 1, bias 0, mean 0, var 1); a flat npz of flax-named
parameters (`weights_path`, or `HDT_DINO_WEIGHTS` / `HDT_VGG_WEIGHTS`)
replaces it. The extractors are frozen: a loss's gradient reaches only the
prediction.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def center_crop_to_multiple(x: torch.Tensor, multiple: int = 14) -> torch.Tensor:
    """Centre-crop NHWC spatial dims down to the nearest multiple
    (256 → 252 at 14)."""
    _, H, W, _ = x.shape
    nh, nw = (H // multiple) * multiple, (W // multiple) * multiple
    top, left = (H - nh) // 2, (W - nw) // 2
    return x[:, top: top + nh, left: left + nw, :]


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's lecun_normal: a normal truncated at ±2σ, σ corrected so that
    the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


class _Dense(nn.Linear):
    """flax Dense / DenseGeneral in `dtype`, lecun-normal kernel, zero bias."""

    def __init__(self, in_features: int, out_features: int, dtype, gen):
        super().__init__(in_features, out_features)
        self.dtype = dtype
        _lecun_normal_(self.weight, in_features, gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _LayerNorm(nn.LayerNorm):
    """flax LayerNorm (eps 1e-6) computed in fp32."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class MultiHeadDotProductAttention(nn.Module):
    """flax nn.MultiHeadDotProductAttention (self-attention, no mask, no
    dropout) in its order of operations: the query is scaled by 1/√d before
    q·kᵀ, and every product and the softmax run in `dtype`."""

    def __init__(self, dim: int, num_heads: int, dtype, gen):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.query = _Dense(dim, dim, dtype, gen)
        self.key = _Dense(dim, dim, dtype, gen)
        self.value = _Dense(dim, dim, dtype, gen)
        self.out = _Dense(dim, dim, dtype, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        heads = self.num_heads
        q, k, v = (proj(x).view(B, N, heads, D // heads)
                   for proj in (self.query, self.key, self.value))
        q = q / math.sqrt(D // heads)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(out.reshape(B, N, D))


class ViTBlock(nn.Module):
    """Pre-norm transformer block with LayerScale (gamma_1, gamma_2) and an
    exact GELU."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype=torch.float32, gen=None):
        super().__init__()
        self.gamma_1 = nn.Parameter(torch.ones(dim))
        self.gamma_2 = nn.Parameter(torch.ones(dim))
        self.norm1 = _LayerNorm(dim)
        self.attn = MultiHeadDotProductAttention(dim, num_heads, dtype, gen)
        self.norm2 = _LayerNorm(dim)
        self.fc1 = _Dense(dim, dim * mlp_ratio, dtype, gen)
        self.fc2 = _Dense(dim * mlp_ratio, dim, dtype, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(self.norm1(x))
        x = x + self.gamma_1.to(h.dtype) * h
        h = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + self.gamma_2.to(h.dtype) * h


def keys_cubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of `jax.image.resize(...,
    "cubic")` along one axis: `scale_and_translate`'s Keys cubic (a = −0.5),
    with the kernel widened by in/out when it downsamples (antialias), each
    column normalized to sum 1."""
    inv_scale = np.float32(in_size / out_size)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
         / kernel_scale)
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _interpolate_pos_embed(pos: torch.Tensor, gh: int, gw: int,
                           cache: Optional[dict] = None) -> torch.Tensor:
    """Resize the (1, N+1, D) position table's square grid to gh×gw as
    `jax.image.resize(..., "cubic")` does (not `F.interpolate`'s bicubic,
    whose a = −0.75 and lack of antialiasing give other values). `cache`
    keeps the resize matrices on the table's device between calls (a copy
    from the host would wait for the card)."""
    n_patches = pos.shape[1] - 1
    side = int(round(n_patches ** 0.5))
    if side == gh and side == gw:
        return pos
    if side * side != n_patches:
        if n_patches == gh * gw:
            return pos
        raise ValueError(
            f"pos_embed has {n_patches} patch positions (not a square grid) "
            f"and cannot be resized to {gh}x{gw}")
    grid = pos[:, 1:].reshape(1, side, side, -1)
    cache = {} if cache is None else cache

    def matrix(n):
        key = (side, n, pos.device, pos.dtype)
        if key not in cache:
            cache[key] = torch.from_numpy(keys_cubic_resize_matrix(side, n)).to(
                pos.device, pos.dtype)
        return cache[key]

    wh, ww = (matrix(n) if n != side else None for n in (gh, gw))
    if wh is not None:
        grid = torch.einsum("bhwd,hH->bHwd", grid, wh)
    if ww is not None:
        grid = torch.einsum("bhwd,wW->bhWd", grid, ww)
    return torch.cat([pos[:, :1], grid.reshape(1, gh * gw, -1)], dim=1)


class ViTSmall(nn.Module):
    """DINOv2-style ViT-S/14: patch 14, dim 384, 6 heads, 12 blocks, a
    37×37 (+ cls) position table. Input NHWC, sides multiples of 14;
    returns the 12 blocks' outputs and the final norm's, each (B, N+1, dim).
    """

    def __init__(self, patch_size: int = 14, dim: int = 384, depth: int = 12,
                 num_heads: int = 6, num_positions: int = 1370,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.patch_size = patch_size
        self.depth = depth
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        _lecun_normal_(self.patch_embed.weight, 3 * patch_size ** 2, gen)
        nn.init.zeros_(self.patch_embed.bias)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(
            0.02 * torch.randn(1, num_positions, dim, generator=gen))
        for i in range(depth):
            self.add_module(f"block_{i}",
                            ViTBlock(dim, num_heads, dtype=dtype, gen=gen))
        self.norm = _LayerNorm(dim)
        self._resize_matrices: dict = {}

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        B, H, W, _ = x.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        dt = self.dtype
        x = F.conv2d(x.permute(0, 3, 1, 2).to(dt),
                     self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)                     # (B, gh·gw, dim)
        # fp32 from here on, as flax promotes the concat with the fp32 token.
        x = torch.cat([self.cls_token.expand(B, -1, -1), x.float()], dim=1)
        x = x + _interpolate_pos_embed(self.pos_embed, gh, gw,
                                       self._resize_matrices)
        feats = []
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
            feats.append(x)
        feats.append(self.norm(x))
        return feats


class DinoPerceptualLoss(nn.Module):
    """Frozen DINO feature matching: smooth-L1 (β 1), a mean per feature,
    summed over the 13 features. Images in [−1, 1], NHWC.

        loss_fn = DinoPerceptualLoss(seed=1, device="cuda")   # random features
        value = loss_fn(pred, target)
    """

    MEAN = (0.485, 0.456, 0.406)
    STD = (0.229, 0.224, 0.225)

    def __init__(self, seed: int = 0, weights_path: Optional[str] = None,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.model = ViTSmall(dtype=dtype, seed=seed)
        self.pretrained = False
        weights_path = weights_path or os.environ.get("HDT_DINO_WEIGHTS")
        if weights_path and os.path.exists(weights_path):
            from ..weights import load_npz_state_dict

            self.model.load_state_dict(load_npz_state_dict(weights_path),
                                       strict=True)
            self.pretrained = True
        self.register_buffer("mean", torch.tensor(self.MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(self.STD), persistent=False)
        self.requires_grad_(False)
        self.to(device)

    def features(self, images: torch.Tensor) -> list[torch.Tensor]:
        x = (images + 1.0) / 2.0
        return self.model(center_crop_to_multiple((x - self.mean) / self.std,
                                                  14))

    def forward(self, pred: torch.Tensor, target: torch.Tensor,
                per_example: bool = False) -> torch.Tensor:
        """A scalar, or with `per_example` one value per image, (B,)."""
        fp = self.features(pred)
        with torch.no_grad():
            ft = self.features(target)
        loss = 0.0
        for a, b in zip(fp, ft):
            d = a - b
            huber = torch.where(d.abs() < 1.0, 0.5 * d * d, d.abs() - 0.5)
            loss = loss + (huber.flatten(1).mean(dim=1) if per_example
                           else huber.mean())
        return loss


# torchvision `features` stack configurations (numbers = conv out-channels,
# "M" = 2×2 max-pool) and the default tap slots per backbone. A slot is one
# entry of torchvision's `features` Sequential (conv, BN, ReLU and pool each
# count one; a SqueezeNet Fire module counts one), reproduced exactly,
# vgg11's pre-ReLU/pool taps and its out-of-range 22 included.
VGG_CFGS: dict[str, list] = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}
VGG_DEFAULT_TAPS: dict[str, list[int]] = {
    "vgg11": [3, 8, 15, 22],
    "vgg13": [3, 8, 15, 22],
    "vgg16": [3, 8, 15, 22],
    "vgg19": [3, 8, 17, 26, 35],
    "squeeze": [3, 7, 12],
    "alex": [3, 6, 8, 10, 12],
}


class _FlaxConv(nn.Conv2d):
    """flax nn.Conv with explicit symmetric padding, in `dtype`:
    lecun-normal kernel, zero bias, NCHW."""

    def __init__(self, in_ch: int, out_ch: int, k: int, dtype, gen,
                 stride: int = 1, padding: int = 0):
        super().__init__(in_ch, out_ch, k, stride=stride, padding=padding)
        self.dtype = dtype
        _lecun_normal_(self.weight, in_ch * k * k, gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        stride=self.stride, padding=self.padding)


class _Taps:
    """Collects the outputs of the tapped slots, counting slots in order."""

    def __init__(self, taps):
        self.taps, self.idx, self.feats = set(taps), 0, []

    def emit(self, y: torch.Tensor) -> torch.Tensor:
        if self.idx in self.taps:
            self.feats.append(y)
        self.idx += 1
        return y


class _VGGFeatures(nn.Module):
    """A torchvision-ordered VGG stack, built and run up to its last tap.
    With `batch_norm` an eval-mode BN (frozen statistics, computed in fp32
    as flax promotes it) sits between each conv and its ReLU."""

    def __init__(self, cfg, taps, batch_norm: bool, dtype, gen):
        super().__init__()
        self.taps = tuple(taps)
        self.batch_norm = batch_norm
        max_tap = max(self.taps) if self.taps else -1
        self.plan, idx, in_ch = [], 0, 3
        for v in cfg:
            if idx > max_tap:           # nothing left to tap
                break
            if v == "M":
                self.plan.append("M")
                idx += 1
                continue
            i = len([p for p in self.plan if p != "M"])
            self.add_module(f"conv_{i}", _FlaxConv(in_ch, v, 3, dtype, gen,
                                                   padding=1))
            if batch_norm:
                for name, init in (("scale", torch.ones), ("bias", torch.zeros),
                                   ("mean", torch.zeros), ("var", torch.ones)):
                    setattr(self, f"bn_{i}_{name}", nn.Parameter(init(v)))
            self.plan.append(i)
            idx += 3 if batch_norm else 2
            in_ch = v

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        out = _Taps(self.taps)
        for step in self.plan:
            if step == "M":
                x = out.emit(F.max_pool2d(x, 2, 2))
                continue
            x = out.emit(getattr(self, f"conv_{step}")(x))
            if self.batch_norm:
                p = {n: getattr(self, f"bn_{step}_{n}")[:, None, None]
                     for n in ("scale", "bias", "mean", "var")}
                x = out.emit((x.float() - p["mean"])
                             * torch.rsqrt(p["var"] + 1e-5) * p["scale"]
                             + p["bias"])
            x = out.emit(F.relu(x))
        return out.feats


class _AlexFeatures(nn.Module):
    """torchvision alexnet.features. Slots: 0 Conv(64,11,s4,p2) 1 ReLU
    2 MaxPool(3,2) 3 Conv(192,5,p2) 4 ReLU 5 MaxPool 6 Conv(384,3,p1)
    7 ReLU 8 Conv(256,3,p1) 9 ReLU 10 Conv(256,3,p1) 11 ReLU 12 MaxPool."""

    CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
             (256, 3, 1, 1), (256, 3, 1, 1)]
    POOLS_AFTER = (0, 1, 4)

    def __init__(self, taps, dtype, gen):
        super().__init__()
        self.taps = tuple(taps)
        in_ch = 3
        for i, (ch, k, s, p) in enumerate(self.CONVS):
            self.add_module(f"conv_{i}", _FlaxConv(in_ch, ch, k, dtype, gen,
                                                   stride=s, padding=p))
            in_ch = ch

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        out = _Taps(self.taps)
        for i in range(len(self.CONVS)):
            x = out.emit(getattr(self, f"conv_{i}")(x))
            x = out.emit(F.relu(x))
            if i in self.POOLS_AFTER:
                x = out.emit(F.max_pool2d(x, 3, 2))
        return out.feats


class _Fire(nn.Module):
    """SqueezeNet Fire: 1×1 squeeze + ReLU, then 1×1 and 3×3 expands, each
    + ReLU, concatenated on channels."""

    def __init__(self, in_ch: int, squeeze_ch: int, expand_ch: int, dtype,
                 gen):
        super().__init__()
        self.squeeze = _FlaxConv(in_ch, squeeze_ch, 1, dtype, gen)
        self.expand1x1 = _FlaxConv(squeeze_ch, expand_ch, 1, dtype, gen)
        self.expand3x3 = _FlaxConv(squeeze_ch, expand_ch, 3, dtype, gen,
                                   padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)),
                          F.relu(self.expand3x3(s))], dim=1)


def _max_pool_ceil(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """MaxPool(k, s, ceil_mode=True), as the JAX package writes it: pad
    right and bottom with −inf so that the last partial window is kept."""
    def pad_amount(n):
        out = -(-(n - k) // s) + 1
        return max((out - 1) * s + k - n, 0)

    ph, pw = pad_amount(x.shape[2]), pad_amount(x.shape[3])
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
    return F.max_pool2d(x, k, s)


class _SqueezeFeatures(nn.Module):
    """torchvision squeezenet1_1.features. Slots: 0 Conv(64,3,s2) 1 ReLU
    2 MaxPool(3,2,ceil) 3-4 Fire(16,64) 5 MaxPool 6-7 Fire(32,128)
    8 MaxPool 9-10 Fire(48,192) 11-12 Fire(64,256)."""

    FIRES = [(16, 64), (16, 64), None, (32, 128), (32, 128), None,
             (48, 192), (48, 192), (64, 256), (64, 256)]

    def __init__(self, taps, dtype, gen):
        super().__init__()
        self.taps = tuple(taps)
        self.conv_0 = _FlaxConv(3, 64, 3, dtype, gen, stride=2)
        in_ch, i = 64, 0
        for cfg in self.FIRES:
            if cfg is not None:
                self.add_module(f"fire_{i}", _Fire(in_ch, cfg[0], cfg[1],
                                                   dtype, gen))
                in_ch, i = 2 * cfg[1], i + 1

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        out = _Taps(self.taps)
        x = out.emit(self.conv_0(x))
        x = out.emit(F.relu(x))
        x = out.emit(_max_pool_ceil(x))
        i = 0
        for cfg in self.FIRES:
            if cfg is None:
                x = out.emit(_max_pool_ceil(x))
            else:
                x = out.emit(getattr(self, f"fire_{i}")(x))
                i += 1
        return out.feats


def vgg_backbones() -> list[str]:
    """The backbones VGGPerceptualLoss takes."""
    return (sorted(VGG_CFGS) + [k + "_bn" for k in sorted(VGG_CFGS)]
            + ["squeeze", "alex"])


class VGGPerceptualLoss(nn.Module):
    """Frozen feature matching: L1 (a mean per tap) summed over the taps,
    the target's features detached. Images in [−1, 1], NHWC, mapped to
    [0, 1] (no ImageNet normalization, as in the JAX package).

    model: vgg11/13/16/19, each with or without `_bn`, "alex" (AlexNet) or
    "squeeze" (SqueezeNet 1.1). layer_indices: tap slots (torchvision
    `features` indices), VGG_DEFAULT_TAPS by default.

        loss_fn = VGGPerceptualLoss(seed=2, device="cuda")   # random features
        value = loss_fn(pred, target)
    """

    def __init__(self, seed: int = 0, weights_path: Optional[str] = None,
                 dtype=torch.float32, model: str = "vgg16",
                 layer_indices: Optional[list[int]] = None, device="cuda"):
        super().__init__()
        base = model[:-3] if model.endswith("_bn") else model
        if model not in vgg_backbones():
            raise ValueError(f"Unsupported perceptual model {model!r}. "
                             f"Choose from {vgg_backbones()}")
        self.taps = tuple(layer_indices if layer_indices is not None
                          else VGG_DEFAULT_TAPS[base])
        gen = torch.Generator().manual_seed(seed)
        if base in VGG_CFGS:
            self.model = _VGGFeatures(VGG_CFGS[base], self.taps,
                                      model.endswith("_bn"), dtype, gen)
        elif model == "alex":
            self.model = _AlexFeatures(self.taps, dtype, gen)
        else:
            self.model = _SqueezeFeatures(self.taps, dtype, gen)
        self.name = f"VGGPerceptualLoss_{model}"
        self.pretrained = False
        weights_path = weights_path or os.environ.get("HDT_VGG_WEIGHTS")
        if weights_path and os.path.exists(weights_path):
            load_npz_strict(self.model, weights_path)
            self.pretrained = True
        self.requires_grad_(False)
        self.to(device)

    def features(self, images: torch.Tensor) -> list[torch.Tensor]:
        return self.model(((images + 1.0) / 2.0).permute(0, 3, 1, 2))

    def forward(self, pred: torch.Tensor, target: torch.Tensor,
                per_example: bool = False) -> torch.Tensor:
        """A scalar, or with `per_example` one value per image, (B,)."""
        fp = self.features(pred)
        with torch.no_grad():
            ft = self.features(target)
        loss = 0.0
        for a, b in zip(fp, ft):
            d = (a - b).abs()
            loss = loss + (d.flatten(1).mean(dim=1) if per_example
                           else d.mean())
        return loss


def load_npz_strict(module: nn.Module, path: str) -> None:
    """Load a flat npz of flax-named parameters ("params/conv_0/kernel",
    ...) into `module`, with the JAX package's `_load_npz_params`
    strictness: an array that matches no parameter raises, and so does a
    shape mismatch (both judged in flax's names and layouts); a parameter
    the file lacks keeps its init."""
    from ..utils.params_io import load_params_npz
    from ..weights import flat_from_state_dict, state_dict_from_flat

    template = flat_from_state_dict(module.state_dict())
    flat = load_params_npz(path)
    unused = sorted(set(flat) - set(template))
    if unused:
        raise ValueError(f"{path}: {len(unused)} arrays match no model "
                         f"parameter, e.g. {unused[:5]}")
    for key, array in flat.items():
        if tuple(array.shape) != tuple(template[key].shape):
            raise ValueError(f"{path}: shape mismatch at {key}: npz "
                             f"{array.shape} vs model {template[key].shape}")
    module.load_state_dict(state_dict_from_flat(flat), strict=False)
