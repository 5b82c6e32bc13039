"""Underwater image quality metrics: UIQM, UCIQE, UISM, UICM, UICONM.

The port's own copy of `hybrid_diffusion_tpu/metrics/uiqm.py` (:1-244).

Vectorized numpy rebuild of the reference's metric suite
(metrics/metrics.py). The reference carries two UIQM implementations that
its eval loops both call (rotinas.py:923-928):

  - `nmetrics(a)` (metrics.py:301-385): skimage-based — Lab/gray color
    transforms, sobel-magnitude sharpness, ceil-block EME with +1 zero
    guards (metrics.py:387-424 — note this later `eme` redefinition
    shadows the earlier one at :128 for module-level callers), PLIP
    logAMEE contrast (:435-473).
  - `getUIQM(x)` (metrics.py:282-299): ndimage-based — asymmetric
    α-trimmed colorfulness (`mu_a`, :77-95, including its s=T_a_L+1 start
    index, replicated for numerical comparability), 255-normalized sobel
    magnitude, floor-block `_uiconm` (:234-279).

Both are reproduced so scores are comparable with reference reports.
Block statistics use `np.minimum.reduceat` over row/col boundaries —
O(HW) with no Python-per-block loops (the reference's double loops are
the slowest part of its eval).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from .color import rgb2gray, rgb2lab

PLIP_GAMMA = 1026.0


def _to_255(rgb: np.ndarray) -> np.ndarray:
    """Canonicalize an RGB image to float64 in the [0, 255] domain.

    The reference's eval loops feed `nmetrics` images scaled to [0, 255]
    (rotinas.py:918-923: `np.clip(...)*255`), and the UIQM family is
    range-sensitive: UISM rounds `ch * sobel` to uint8 (zero on [0,1]
    inputs) and the PLIP logAMEE constants (γ=1026) assume 0-255
    intensities. Accept uint8, float [0,1] (scaled up), or float [0,255]
    so every caller lands on the reference's domain.
    """
    rgb = np.asarray(rgb)
    if rgb.dtype == np.uint8:
        return rgb.astype(np.float64)
    rgb = rgb.astype(np.float64)
    if rgb.size and rgb.max() <= 1.0:
        return rgb * 255.0
    return rgb


# ---------- block statistics helpers ----------

def _block_min_max(x: np.ndarray, blocksize: int):
    """Per-block (min, max) with ceil-blocks (edge blocks take remainder)."""
    rb = np.arange(0, x.shape[0], blocksize)
    cb = np.arange(0, x.shape[1], blocksize)
    mins = np.minimum.reduceat(np.minimum.reduceat(x, rb, 0), cb, 1)
    maxs = np.maximum.reduceat(np.maximum.reduceat(x, rb, 0), cb, 1)
    return mins, maxs


def eme(ch: np.ndarray, blocksize: int = 8) -> float:
    """Ceil-block enhancement measure: (2/K)·Σ log(max/min), zeros bumped
    to 1 (metrics.py:387-424)."""
    ch = np.asarray(ch, np.float64)
    mins, maxs = _block_min_max(ch, blocksize)
    mins = np.where(mins == 0, 1.0, mins)
    maxs = np.where(maxs == 0, 1.0, maxs)
    w = 2.0 / mins.size
    return float(w * np.sum(np.log(maxs / mins)))


def logamee(ch: np.ndarray, blocksize: int = 8) -> float:
    """PLIP logAMEE contrast over ceil blocks (metrics.py:435-473)."""
    ch = np.asarray(ch, np.float64)
    mins, maxs = _block_min_max(ch, blocksize)
    g = PLIP_GAMMA
    top = g * (maxs - mins) / (g - mins)        # plipsub(max, min)
    bottom = maxs + mins - maxs * mins / g       # plipsum(max, min)
    with np.errstate(divide="ignore", invalid="ignore"):
        m = np.where(bottom == 0, 0.0, top / bottom)
        terms = np.where(m != 0, m * np.log(np.abs(m)), 0.0)
    s = float(np.sum(terms))
    w = 1.0 / mins.size
    return float(g - g * (1.0 - s / g) ** w)     # plipmult(w, s)


# ---------- nmetrics (skimage-style pipeline) ----------

def _sobel_magnitude(ch: np.ndarray) -> np.ndarray:
    """skimage.filters.sobel-compatible edge magnitude: smoothed derivative
    kernels scaled by 1/4, magnitude / sqrt(2), reflect boundaries."""
    h = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], np.float64) / 4.0
    gx = ndimage.convolve(ch.astype(np.float64), h, mode="reflect")
    gy = ndimage.convolve(ch.astype(np.float64), h.T, mode="reflect")
    return np.sqrt(gx**2 + gy**2) / np.sqrt(2.0)


def uicm(rgb: np.ndarray) -> float:
    """Colorfulness via 10%-trimmed rg/yb statistics (metrics.py:347-364)."""
    rgb = _to_255(rgb)
    rg = (rgb[..., 0] - rgb[..., 1]).ravel()
    yb = ((rgb[..., 0] + rgb[..., 1]) / 2 - rgb[..., 2]).ravel()
    T = int(0.1 * rg.size)
    rg_t = np.sort(rg)[T:-T] if T else np.sort(rg)
    yb_t = np.sort(yb)[T:-T] if T else np.sort(yb)
    urg, uyb = rg_t.mean(), yb_t.mean()
    s2rg = np.mean((rg_t - urg) ** 2)
    s2yb = np.mean((yb_t - uyb) ** 2)
    return float(-0.0268 * np.hypot(urg, uyb) + 0.1586 * np.sqrt(s2rg + s2yb))


def uism(rgb: np.ndarray) -> float:
    """Sharpness: sobel-magnitude-weighted channels → uint8 → EME
    (metrics.py:366-379). Range-sensitive: must run on 0-255 intensities
    (the uint8 round of `ch * sobel` collapses to zero on [0,1] inputs)."""
    rgb = _to_255(rgb)
    emes = []
    for c in range(3):
        ch = rgb[..., c]
        edge = np.round(ch * _sobel_magnitude(ch)).astype(np.uint8)
        emes.append(eme(edge, 8))
    return float(0.299 * emes[0] + 0.587 * emes[1] + 0.114 * emes[2])


def uiconm(rgb: np.ndarray) -> float:
    """Contrast: logAMEE of the luma channel (metrics.py:381-382).

    Luma stays on the 0-255 scale: the reference applies skimage rgb2gray
    (pure coefficient mix) to [0,255] floats, which is also the scale the
    PLIP γ=1026 constants are designed for.
    """
    rgb255 = _to_255(rgb)
    luma = (rgb255[..., 0] * 0.2125 + rgb255[..., 1] * 0.7154
            + rgb255[..., 2] * 0.0721)
    return logamee(luma)


def uciqe(rgb: np.ndarray) -> float:
    """UCIQE = 0.4680·σ_chroma + 0.2745·con_l + 0.2576·μ_sat
    (metrics.py:305-337).

    Recorded divergence: the reference pushes [0,255] *floats* into
    skimage `rgb2lab`, which assumes [0,1] floats — an unambiguous bug
    (out-of-gamut Lab). We convert on the correct [0,1] scale instead
    (SURVEY §7 policy: fix unambiguous bugs, record the divergence).
    """
    lab = rgb2lab(_to_255(rgb) / 255.0)
    L = lab[..., 0]
    chroma = np.hypot(lab[..., 1], lab[..., 2])
    sc = float(np.sqrt(np.mean((chroma - chroma.mean()) ** 2)))

    top = int(np.round(0.01 * L.size))
    ls = np.sort(L, axis=None)
    conl = float(ls[-top:].mean() - ls[:top].mean()) if top else 0.0

    with np.errstate(divide="ignore", invalid="ignore"):
        sat = np.where((chroma == 0) | (L == 0), 0.0, chroma / L)
    us = float(sat.mean())
    return 0.4680 * sc + 0.2745 * conl + 0.2576 * us


def nmetrics(rgb: np.ndarray) -> tuple[float, float, float, float, float]:
    """(uiqm, uciqe, uism, uicm, uiconm) — the reference's all-in-one
    evaluator (metrics.py:301-385). Input: HWC RGB — uint8, float [0,1],
    or float [0,255]; all are canonicalized to the reference's 0-255
    domain (see `_to_255`)."""
    _uicm = uicm(rgb)
    _uism = uism(rgb)
    _uiconm = uiconm(rgb)
    _uiqm = 0.0282 * _uicm + 0.2953 * _uism + 3.5753 * _uiconm
    return _uiqm, uciqe(rgb), _uism, _uicm, _uiconm


# ---------- getUIQM (ndimage-style pipeline) ----------

def _mu_a(x: np.ndarray, alpha_l: float = 0.1, alpha_r: float = 0.1) -> float:
    """Asymmetric α-trimmed mean, replicating the reference's start index
    s = T_a_L + 1 (metrics.py:77-95) for score comparability."""
    x = np.sort(np.asarray(x, np.float64))
    K = x.size
    T_l = int(np.ceil(alpha_l * K))
    T_r = int(np.floor(alpha_r * K))
    s, e = T_l + 1, K - T_r
    return float(x[s:e].sum() / (K - T_l - T_r))


def _s_a(x: np.ndarray, mu: float) -> float:
    x = np.asarray(x, np.float64)
    return float(np.mean((x - mu) ** 2))


def _uicm_trimmed(x: np.ndarray) -> float:
    R, G, B = (x[..., i].ravel() for i in range(3))
    rg, yb = R - G, (R + G) / 2 - B
    mu_rg, mu_yb = _mu_a(rg), _mu_a(yb)
    s_rg, s_yb = _s_a(rg, mu_rg), _s_a(yb, mu_yb)
    return float(-0.0268 * np.hypot(mu_rg, mu_yb)
                 + 0.1586 * np.sqrt(s_rg + s_yb))


def _uism_ndimage(x: np.ndarray) -> float:
    emes = []
    for c in range(3):
        ch = x[..., c].astype(np.float64)
        dx = ndimage.sobel(ch, 0)
        dy = ndimage.sobel(ch, 1)
        mag = np.hypot(dx, dy)
        mx = mag.max()
        if mx > 0:
            mag = mag * (255.0 / mx)
        emes.append(eme(mag * ch, 8))
    return float(0.299 * emes[0] + 0.587 * emes[1] + 0.144 * emes[2])


def _uiconm_blocks(x: np.ndarray, blocksize: int = 8) -> float:
    """Floor-block Michelson-entropy contrast (metrics.py:234-279)."""
    x = np.asarray(x, np.float64)
    k1 = x.shape[1] // blocksize
    k2 = x.shape[0] // blocksize
    if k1 == 0 or k2 == 0:
        return 0.0
    crop = x[: k2 * blocksize, : k1 * blocksize]
    blocks = crop.reshape(k2, blocksize, k1, blocksize, -1)
    maxs = blocks.max(axis=(1, 3, 4))
    mins = blocks.min(axis=(1, 3, 4))
    top, bot = maxs - mins, maxs + mins
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where((bot == 0) | (top == 0), np.nan, top / bot)
        terms = np.where(np.isnan(r), 0.0, r * np.log(np.where(np.isnan(r), 1.0, r)))
    return float(-1.0 / (k1 * k2) * np.sum(terms))


def getUIQM(rgb: np.ndarray) -> float:
    """UIQM = 0.0282·UICM + 0.2953·UISM + 3.5753·UICONM via the ndimage
    pipeline (metrics.py:282-299). Input canonicalized to 0-255 like
    `nmetrics` (the reference feeds this the same [0,255] images)."""
    x = _to_255(rgb).astype(np.float32)
    return float(
        0.0282 * _uicm_trimmed(x)
        + 0.2953 * _uism_ndimage(x)
        + 3.5753 * _uiconm_blocks(x, 8)
    )
