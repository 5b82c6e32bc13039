"""Fréchet Inception Distance.

Counterpart of `hybrid_diffusion_tpu/metrics/fid.py` (:39-327): the same
InceptionV3 trunk, tower for tower and with the flax module names (so the
JAX package's parameters carry over by path, `weights.py`), computing on
the card; the Fréchet distance in numpy, as in JAX.

  - BasicConv2d = conv (no bias) + BatchNorm (ε 1e-3, running statistics)
    + ReLU; `_pool3` is a 3×3 stride-2 VALID max pool; `_avg3` a 3×3
    stride-1 SAME average pool that counts the padding (÷ 9);
  - images are NHWC at the boundary, as in JAX, and NCHW inside;
  - pretrained weights load from a flat npz of the flax variables
    (`params/...` and `batch_stats/...`, HDT_INCEPTION_WEIGHTS or
    `weights_path`); otherwise the convolutions take flax's default init
    (lecun normal, truncated at two standard deviations) drawn from a
    seed and are He-rescaled by √2 (`feature_mode == "random_he"`): without
    that, the deep ReLU chain shrinks the random features to ~1e-5 and every
    FID to ~1e-7. A random-init FID is self-consistent only; it is not
    comparable to an Inception-weights FID, nor to the JAX package's random
    FID, whose init comes from another generator.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device
from ..utils.precision import full_fp32

MIN_INCEPTION_SIZE = 75  # VALID-conv chain yields 0 pixels below this


class BasicConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int],
                 stride: int = 1, same: bool = False):
        super().__init__()
        kh, kw = kernel
        self.conv = nn.Conv2d(in_ch, out_ch, (kh, kw), stride=stride,
                              padding=(kh // 2, kw // 2) if same else 0,
                              bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _pool3(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


def _avg3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(in_ch, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), same=True)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), same=True)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), same=True)
        self.branch_pool = BasicConv2d(in_ch, pool_features, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), same=True)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _pool3(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(in_ch, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), same=True)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), same=True)
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), same=True)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), same=True)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), same=True)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), same=True)
        self.branch_pool = BasicConv2d(in_ch, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), same=True)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), same=True)
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _pool3(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(in_ch, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), same=True)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), same=True)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), same=True)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), same=True)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), same=True)
        self.branch_pool = BasicConv2d(in_ch, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        bp = self.branch_pool(_avg3(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3Features(nn.Module):
    """InceptionV3 trunk → 2048-d global-average-pool features.

    Takes (B, H, W, 3) images with H, W ≥ 75 (below that the VALID stride
    chain reaches zero pixels); FID.extract_features upsamples smaller
    inputs.
    """

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), same=True)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] < MIN_INCEPTION_SIZE or x.shape[2] < MIN_INCEPTION_SIZE:
            raise ValueError(
                f"InceptionV3 needs ≥{MIN_INCEPTION_SIZE}px inputs, got "
                f"{x.shape[1]}x{x.shape[2]} (would reduce to 0 pixels)")
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _pool3(x)
        x = _pool3(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def _flax_default_init_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's defaults: conv kernels lecun-normal (variance 1/fan_in,
    truncated at ±2σ of the underlying normal), BatchNorm scale 1, bias 0,
    running mean 0, variance 1."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def _he_rescale_convs(model: nn.Module) -> None:
    """Multiply every conv kernel by √2 (lecun-normal → He), in place."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.mul_(math.sqrt(2.0))


class FID:
    """Fréchet Inception Distance between two image sets.

    Images: NHWC float in [0, 1], or uint8 (numpy arrays or tensors). The
    features run on `device` in fp32 (TF32 off); the statistics in float64
    numpy.
    """

    def __init__(self, weights_path: Optional[str] = None,
                 image_size: int = 256, device="cuda", seed: int = 0):
        self.device = resolve_device(device)
        self.model = InceptionV3Features()
        weights_path = weights_path or os.environ.get("HDT_INCEPTION_WEIGHTS")
        if weights_path and os.path.exists(weights_path):
            from ..utils.params_io import load_params_npz
            from ..weights import inception_state_dict_from_flat

            self.model.load_state_dict(
                inception_state_dict_from_flat(load_params_npz(weights_path)),
                strict=True)
            self.pretrained = True
            self.feature_mode = "pretrained"
        else:
            _flax_default_init_(self.model,
                                torch.Generator().manual_seed(seed))
            _he_rescale_convs(self.model)
            self.pretrained = False
            self.feature_mode = "random_he"
        self.model = self.model.to(self.device).eval()
        self.image_size = image_size

    @torch.no_grad()
    def extract_features(self, images) -> np.ndarray:
        x = torch.as_tensor(images).to(self.device)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        x = x.float().clamp(0.0, 1.0)
        if (x.shape[1] < MIN_INCEPTION_SIZE
                or x.shape[2] < MIN_INCEPTION_SIZE):
            x = F.interpolate(x.permute(0, 3, 1, 2),
                              size=(MIN_INCEPTION_SIZE, MIN_INCEPTION_SIZE),
                              mode="bilinear", align_corners=False)
            x = x.permute(0, 2, 3, 1)
        with full_fp32():
            feats = self.model(x)
        return feats.double().cpu().numpy()

    @staticmethod
    def _stats(feats: np.ndarray):
        return feats.mean(axis=0), np.cov(feats, rowvar=False)

    @staticmethod
    def _trace_sqrt_product(sigma1: np.ndarray, sigma2: np.ndarray) -> float:
        """tr(sqrtm(Σ1·Σ2)) via symmetric eigendecompositions: for PSD Σ1,
        Σ2 the eigenvalues of Σ1Σ2 equal those of sqrt(Σ1)·Σ2·sqrt(Σ1)."""
        w1, v1 = np.linalg.eigh(sigma1)
        s1h = (v1 * np.sqrt(np.clip(w1, 0, None))) @ v1.T  # sqrt(Σ1)
        m = s1h @ sigma2 @ s1h
        lam = np.linalg.eigvalsh((m + m.T) / 2.0)
        return float(np.sqrt(np.clip(lam, 0, None)).sum())

    @staticmethod
    def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
        diff = mu1 - mu2
        tsp = FID._trace_sqrt_product(np.asarray(sigma1, np.float64),
                                      np.asarray(sigma2, np.float64))
        return float(np.sum(diff**2)
                     + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tsp)

    @staticmethod
    def frechet_from_features(f1: np.ndarray, f2: np.ndarray) -> float:
        """Fréchet distance straight from feature matrices (n, d); with
        n < d the trace term comes from the n₁×n₁ matrix (a1·a2ᵀ)(a1·a2ᵀ)ᵀ
        over (n1−1)(n2−1), a the centred features."""
        f1 = np.asarray(f1, np.float64)
        f2 = np.asarray(f2, np.float64)
        n1, d = f1.shape
        mu1, mu2 = f1.mean(0), f2.mean(0)
        if min(n1, f2.shape[0]) >= d:
            s1, s2 = np.cov(f1, rowvar=False), np.cov(f2, rowvar=False)
            return FID.frechet_distance(mu1, s1, mu2, s2)
        a1 = f1 - mu1
        a2 = f2 - mu2
        b = a1 @ a2.T
        m = (b @ b.T) / ((n1 - 1) * (f2.shape[0] - 1))
        m = (m + m.T) / 2.0
        lam = np.linalg.eigvalsh(m)
        tsp = float(np.sqrt(np.clip(lam, 0, None)).sum())
        tr1 = float((a1 * a1).sum() / (n1 - 1))
        tr2 = float((a2 * a2).sum() / (f2.shape[0] - 1))
        return float(np.sum((mu1 - mu2) ** 2) + tr1 + tr2 - 2.0 * tsp)

    def compute_fid(self, real_images, generated_images) -> float:
        fr = self.extract_features(real_images)
        fg = self.extract_features(generated_images)
        return self.frechet_from_features(fr, fg)


class StreamingFID:
    """Accumulate features batch by batch, compute FID once over all."""

    def __init__(self, fid: FID):
        self.fid = fid
        self._real: list[np.ndarray] = []
        self._fake: list[np.ndarray] = []

    def update(self, real_images, generated_images) -> None:
        self._real.append(self.fid.extract_features(real_images))
        self._fake.append(self.fid.extract_features(generated_images))

    def compute(self) -> float:
        fr = np.concatenate(self._real)
        fg = np.concatenate(self._fake)
        return self.fid.frechet_from_features(fr, fg)
