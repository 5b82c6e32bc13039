"""Dataset path-loader registry for the seven enhancement corpora.

The port's own copy of `hybrid_diffusion_tpu/data/registry.py` (:35-238).
The JAX package's module rebuilds the glob-based loaders of the reference (utils/utils.py:82-285)
as a declarative registry. Each entry describes where degraded ("input")
and ground-truth ("gt") images live relative to the dataset root and how
train/test/val splits are obtained:

  - explicit-dirs layouts (HICRD, LoLI): the corpus ships Train/Test/Val
    directories for both sides (utils.py:139-177, 226-285);
  - single-pool layouts (EUVP, HDR, LSUI, TM-DIED, UIEB, RUIE): one glob
    pool split 70/10/20 (utils.py:44-77) — order of the returned tuple is
    (train, test, val) to match the reference's split_data contract;
  - self-supervised layouts (TM-DIED, UIEB, RUIE-no-annt): no GT pairs —
    the input pool doubles as GT (utils.py:336-338, 419-421).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import random
from typing import Callable, Optional

import numpy as np

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg")

# Default sets accepted by the two Dataset families (utils.py:330-344,
# 411-430).
UNDERWATER_DATASETS = ("HICRD", "LSUI", "UIEB", "RUIE", "EUVP")
ATMOSPHERIC_DATASETS = ("HDR", "TM-DIED", "LoLI")


def list_images(directory: str) -> list[str]:
    """Recursively list image files under `directory` (utils.py:24-39)."""
    out = []
    for root, _dirs, files in os.walk(directory):
        for f in files:
            if f.lower().endswith(IMAGE_EXTENSIONS):
                out.append(os.path.join(root, f))
    return sorted(out)


def split_data(
    paths: list[str],
    train_ratio: float = 0.7,
    val_ratio: float = 0.1,
    test_ratio: float = 0.2,
    shuffle: bool = False,
    seed: int = 0,
) -> tuple[list[str], list[str], list[str]]:
    """70/10/20 split; returns (train, test, val) — the reference's
    return order (utils.py:44-77)."""
    if abs(train_ratio + val_ratio + test_ratio - 1.0) > 1e-6:
        raise ValueError("split ratios must sum to 1")
    paths = list(paths)
    if shuffle:
        random.Random(seed).shuffle(paths)
    n = len(paths)
    n_train = int(n * train_ratio)
    n_val = int(n * val_ratio)
    train = paths[:n_train]
    val = paths[n_train : n_train + n_val]
    test = paths[n_train + n_val :]
    return train, test, val


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Declarative description of one corpus layout."""

    name: str
    domain: str  # "underwater" | "atmospheric"
    # Either explicit per-split glob patterns...
    input_globs: Optional[dict[str, str]] = None   # {"train": pat, ...}
    gt_globs: Optional[dict[str, str]] = None
    # ...or a single pool pattern that gets split 70/10/20.
    input_pool: Optional[str] = None
    gt_pool: Optional[str] = None
    # Self-supervised: GT side mirrors the input side.
    self_supervised: bool = False


DATASET_REGISTRY: dict[str, DatasetSpec] = {
    # Underwater (reference: utils.py:139-224, 411-430)
    "HICRD": DatasetSpec(
        name="HICRD", domain="underwater",
        input_globs={
            "train": "Train/trainA_paired/*.png",
            "test": "Test/testA/*.png",
            "val": "Val/valA/*.png",
        },
        gt_globs={
            "train": "Train/trainB_paired/*.png",
            "test": "Test/testB/*.png",
            "val": "Val/valB/*.png",
        },
    ),
    "LSUI": DatasetSpec(
        name="LSUI", domain="underwater",
        input_pool="input/*.jpg", gt_pool="GT/*.jpg",
    ),
    "UIEB": DatasetSpec(
        name="UIEB", domain="underwater",
        input_pool="train/*.png", self_supervised=True,
    ),
    "RUIE": DatasetSpec(
        name="RUIE", domain="underwater",
        input_pool="*/train/*.jpg", self_supervised=True,
    ),
    "EUVP": DatasetSpec(
        name="EUVP", domain="underwater",
        input_pool="Paired/*/trainA/*.jpg", self_supervised=True,
    ),
    # Atmospheric (reference: utils.py:102-137, 195-201, 226-285, 330-344)
    "HDR": DatasetSpec(
        name="HDR", domain="atmospheric",
        input_pool="gallery_20171023/*.jpg",
        gt_pool="results_20161014/*/*.jpg",
    ),
    "TM-DIED": DatasetSpec(
        name="TM-DIED", domain="atmospheric",
        input_pool="*.jpg", self_supervised=True,
    ),
    "LoLI": DatasetSpec(
        name="LoLI", domain="atmospheric",
        input_globs={
            "train": "Train/low/*.jpg",
            "test": "Test/low/*.jpg",
            "val": "Val/low/*.jpg",
        },
        gt_globs={
            "train": "Train/high/*.jpg",
            "test": "Test/high/*.jpg",
            "val": "Val/high/*.jpg",
        },
    ),
}


def _resolve(root: str, pattern: str) -> list[str]:
    return sorted(glob.glob(os.path.join(root, pattern)))


def dataset_splits(
    name: str, dataset_path: str = "./data/"
) -> dict[str, tuple[list[str], list[str]]]:
    """Return {"train"/"test"/"val": (input_paths, gt_paths)} for a corpus.

    dataset_path is the parent data dir; the corpus lives under
    dataset_path/<name> (matching the reference's data/<name> defaults).
    """
    spec = DATASET_REGISTRY.get(name)
    if spec is None:
        raise ValueError(
            f"Unknown dataset {name!r}. Registered: {sorted(DATASET_REGISTRY)}"
        )
    root = os.path.join(dataset_path, spec.name if name != "HDR"
                        else "HDR+ Burst_20171106_subset")

    if spec.input_globs is not None:
        out = {}
        for task in ("train", "test", "val"):
            inp = _resolve(root, spec.input_globs[task])
            gt = (_resolve(root, spec.gt_globs[task])
                  if spec.gt_globs else list(inp))
            out[task] = (inp, gt)
        return out

    pool = _resolve(root, spec.input_pool)
    tr, te, va = split_data(pool)
    if spec.self_supervised or spec.gt_pool is None:
        return {"train": (tr, list(tr)), "test": (te, list(te)),
                "val": (va, list(va))}
    gt_pool = _resolve(root, spec.gt_pool)
    gtr, gte, gva = split_data(gt_pool)
    return {"train": (tr, gtr), "test": (te, gte), "val": (va, gva)}


def load_image(path: str) -> np.ndarray:
    """Load an image file to RGB uint8 HWC (reference: utils.py:287-306).

    Decoders in the JAX package's order: the native C++ JPEG/PNG decoder
    (native/image_pipe.cpp, libjpeg/libpng), then cv2, then PIL, whichever
    is importable. When none decodes the file, the error names the file
    and the decoders that were missing or refused it.
    """
    from .native import decode_image, decode_supported

    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        raise FileNotFoundError(f"cannot load image: {path}")
    img = decode_image(data)
    if img is not None:
        return img
    tried = ["native decoder: " + ("refused the bytes" if decode_supported()
                                   else "not built with libjpeg/libpng")]
    try:
        import cv2
    except ImportError:
        tried.append("cv2: not installed")
    else:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is not None:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        tried.append("cv2: could not decode")
    try:
        from PIL import Image
    except ImportError:
        tried.append("PIL: not installed")
    else:
        try:
            with Image.open(path) as im:
                return np.asarray(im.convert("RGB"))
        except OSError:
            tried.append("PIL: could not decode")
    raise FileNotFoundError(f"cannot decode image {path}: " + "; ".join(tried))


def resize_image(img: np.ndarray, size: int) -> np.ndarray:
    """Resize HWC uint8 to (size, size) with bilinear interpolation
    (the albumentations Resize default the reference uses, utils.py:318).

    Uses the native C++ core (native/image_pipe.cpp) when built — same
    half-pixel-center convention as cv2 INTER_LINEAR (±1 LSB) — and its
    numpy twin, which gives the same bytes, when it is not."""
    from .native import BILINEAR
    from .native import resize as native_resize

    return native_resize(img, (size, size), BILINEAR)


def resize_image_wh(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Resize HWC uint8 to (height, width) — non-square variant of
    resize_image (serving's ?size=WxH output override)."""
    from .native import BILINEAR
    from .native import resize as native_resize

    return native_resize(img, (height, width), BILINEAR)


def _png_bytes(rgb: np.ndarray) -> bytes:
    """An RGB uint8 HWC image as PNG bytes (8-bit truecolour, no filter,
    zlib): the writer of last resort, with the standard library alone."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_image(path: str, rgb: np.ndarray) -> None:
    """Write an RGB uint8 HWC image with cv2, else PIL, as the JAX package
    writes its outputs; without either, a `.png` path is written by
    `_png_bytes`, and any other raises naming what is missing."""
    try:
        import cv2
    except ImportError:
        pass
    else:
        if not cv2.imwrite(path, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)):
            raise OSError(f"cv2 could not write {path}")
        return
    try:
        from PIL import Image
    except ImportError:
        pass
    else:
        Image.fromarray(rgb).save(path)
        return
    if not path.lower().endswith(".png"):
        raise RuntimeError(f"cannot write {path}: neither cv2 nor PIL is "
                           f"installed, and without them only .png is written")
    with open(path, "wb") as f:
        f.write(_png_bytes(rgb))
