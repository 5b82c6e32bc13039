"""Paired image datasets.

The port's own copy of `hybrid_diffusion_tpu/data/datasets.py` (:26-196):
every item is bit-identical to the JAX package's. The JAX module replaces the reference's Underwater_Dataset / Atmospheric_Dataset
(utils/utils.py:309-473): indexable sources of (degraded, gt[, filename])
pairs at a fixed resolution, returning uint8 HWC numpy — normalization
happens on the device (train/step.py:normalize_uint8), so host→device traffic
stays 1 byte/pixel (the reference also ships uint8 tensors, utils.py:
318-323).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .registry import (
    ATMOSPHERIC_DATASETS,
    UNDERWATER_DATASETS,
    dataset_splits,
    load_image,
    resize_image,
)


class PairedImageDataset:
    """Filesystem-backed (input, gt) pairs for one corpus and task split."""

    def __init__(
        self,
        name: str,
        task: str = "train",
        dataset_path: str = "./data/",
        image_size: int = 256,
        supervised: bool = True,
    ):
        if task not in ("train", "test", "val"):
            raise ValueError(f"task must be train/test/val, got {task!r}")
        splits = dataset_splits(name, dataset_path)
        self.input_paths, self.gt_paths = splits[task]
        if supervised and len(self.input_paths) != len(self.gt_paths):
            n = min(len(self.input_paths), len(self.gt_paths))
            self.input_paths, self.gt_paths = (
                self.input_paths[:n], self.gt_paths[:n])
        self.name = name
        self.task = task
        self.image_size = image_size
        self.supervised = supervised

    def __len__(self) -> int:
        return len(self.input_paths)

    def __getitem__(self, idx: int) -> dict:
        inp = resize_image(load_image(self.input_paths[idx]), self.image_size)
        if self.supervised:
            gt = resize_image(load_image(self.gt_paths[idx]), self.image_size)
        else:
            gt = inp
        return {
            "input": inp,
            "gt": gt,
            "name": self.input_paths[idx].rsplit("/", 1)[-1],
        }

    def get_batch(self, indices) -> Optional[dict]:
        """Fused native fast path (BatchLoader uses it when present): read
        every file of the batch, then ONE C call decodes + resizes inputs
        and gts into contiguous uint8 NHWC buffers
        (native.batch_decode_resize — no per-image Python dispatch).

        Returns None when the native decoder is unavailable or any blob
        isn't JPEG/PNG; the caller falls back to per-item __getitem__.
        """
        from .native import BILINEAR, batch_decode_resize, decode_supported

        if not decode_supported():
            return None
        paths = [self.input_paths[i] for i in indices]
        gpaths = [self.gt_paths[i] for i in indices] if self.supervised else []
        try:
            blobs = []
            for p in paths + gpaths:
                with open(p, "rb") as f:
                    blobs.append(f.read())
        except OSError:
            return None
        batch, ok = batch_decode_resize(
            blobs, (self.image_size, self.image_size), BILINEAR)
        if not ok.all():
            return None  # exotic format in the batch — per-item fallback
        n = len(paths)
        inp = batch[:n]
        return {
            "input": inp,
            "gt": batch[n:] if self.supervised else inp,
            "name": [p.rsplit("/", 1)[-1] for p in paths],
        }


class SyntheticPairedDataset:
    """Deterministic synthetic degraded/clean pairs for tests and benches.

    The real corpora (UIEB/HICRD/LoLI, …) are not shipped with the
    reference snapshot either (`.MISSING_LARGE_BLOBS`); this fixture
    produces structured images (color gradients + shapes) with a synthetic
    underwater (blue-shifted, contrast-crushed) or atmospheric (darkened)
    degradation so enhancement training has real signal to learn.
    """

    def __init__(
        self,
        length: int = 64,
        image_size: int = 256,
        domain: str = "underwater",
        seed: int = 0,
    ):
        assert domain in ("underwater", "atmospheric")
        self.length = length
        self.image_size = image_size
        self.domain = domain
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def _clean(self, rng: np.random.RandomState) -> np.ndarray:
        s = self.image_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        base = np.stack(
            [
                0.5 + 0.5 * np.sin(2 * np.pi * (xx * rng.uniform(1, 3))),
                0.5 + 0.5 * np.cos(2 * np.pi * (yy * rng.uniform(1, 3))),
                0.5 + 0.5 * np.sin(2 * np.pi * (xx + yy) * rng.uniform(1, 2)),
            ],
            axis=-1,
        )
        # A few random bright rectangles for edges/sharpness signal.
        for _ in range(4):
            x0, y0 = rng.randint(0, max(s - s // 4, 1), 2)
            w, h = rng.randint(max(s // 16, 2), max(s // 4, 3), 2)
            base[y0 : y0 + h, x0 : x0 + w] = rng.uniform(0.2, 1.0, 3)
        return np.clip(base * 255, 0, 255).astype(np.uint8)

    def _degrade(self, img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        x = img.astype(np.float32) / 255.0
        if self.domain == "underwater":
            # Attenuate red, boost blue-green, crush contrast — crude
            # water-column transmission model.
            atten = np.array([0.35, 0.75, 0.95], np.float32)
            x = x * atten + np.array([0.0, 0.05, 0.12], np.float32)
            x = 0.7 * x + 0.1
        else:
            # Low light: gamma-darken + noise.
            x = np.power(x, 2.2) * 0.35
        x = x + rng.normal(0, 0.02, x.shape).astype(np.float32)
        return np.clip(x * 255, 0, 255).astype(np.uint8)

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        gt = self._clean(rng)
        return {
            "input": self._degrade(gt, rng),
            "gt": gt,
            "name": f"synthetic_{self.domain}_{idx:05d}.png",
        }


def make_dataset(
    name: str,
    task: str = "train",
    dataset_path: str = "./data/",
    image_size: int = 256,
    supervised: bool = True,
    synthetic_length: int = 64,
):
    """Dataset factory: corpus name, or "synthetic-underwater" /
    "synthetic-atmospheric" for the fixture."""
    if name.startswith("synthetic"):
        domain = name.split("-", 1)[1] if "-" in name else "underwater"
        # Disjoint splits, 70/10/20-proportioned like registry.split_data
        # (utils.py:44): task-specific seeds make val/test images the model
        # never trained on.
        if task == "val":
            length, seed = max(synthetic_length // 7, 2), 1
        elif task == "test":
            length, seed = max(synthetic_length * 2 // 7, 2), 2
        else:
            length, seed = synthetic_length, 0
        return SyntheticPairedDataset(
            length=length, image_size=image_size, domain=domain, seed=seed
        )
    if name not in UNDERWATER_DATASETS + ATMOSPHERIC_DATASETS:
        raise ValueError(f"Unknown dataset {name!r}")
    return PairedImageDataset(
        name, task, dataset_path, image_size, supervised
    )
