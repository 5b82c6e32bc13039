"""Labeled images for the classifier-free-guidance subsystem.

Counterpart of `hybrid_diffusion_tpu/cfg/data.py`:

  - `CIFAR10Dataset` reads the standard `cifar-10-batches-py` pickle layout
    from a local directory (no network: the files must be there);
  - `SyntheticLabeledDataset` makes class-structured images (a per-class
    base colour and spatial frequency plus seeded noise), bit-equal to the
    JAX package's for the same seed, length and size;
  - `make_labeled_dataset` takes CIFAR-10 when its files exist, else the
    synthetic set.

Both yield {"image": uint8 (H, W, 3), "label": int in [0, 10)} and plug into
the port's BatchLoader.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np


class CIFAR10Dataset:
    """Local-file CIFAR-10 (train: data_batch_1..5, test: test_batch).

    The batches are Python pickles: read only files from a trusted copy of
    the dataset.
    """

    def __init__(self, root: str, train: bool = True):
        base = os.path.join(root, "cifar-10-batches-py")
        names = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        images, labels = [], []
        for name in names:
            path = os.path.join(base, name)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"CIFAR-10 batch not found: {path} (no network egress; "
                    "place the extracted cifar-10-batches-py under "
                    f"{root!r} or use SyntheticLabeledDataset)")
            with open(path, "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            images.append(np.asarray(batch[b"data"], np.uint8))
            labels.extend(batch[b"labels"])
        data = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.images = np.ascontiguousarray(data.transpose(0, 2, 3, 1))
        self.labels = np.asarray(labels, np.int32)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, idx: int) -> dict:
        return {"image": self.images[idx], "label": int(self.labels[idx])}


class SyntheticLabeledDataset:
    """Deterministic class-structured images for runs without the data."""

    NUM_CLASSES = 10

    def __init__(self, length: int = 256, image_size: int = 32, seed: int = 0):
        self.length = length
        self.image_size = image_size
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        label = idx % self.NUM_CLASSES
        s = self.image_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        hue = np.array([(label * 25 % 255), (label * 97 % 255),
                        (label * 161 % 255)], np.float32)
        freq = 1.0 + label
        pattern = 0.5 + 0.5 * np.sin(2 * np.pi * freq * (yy + xx))[..., None]
        img = hue * pattern + rng.uniform(0, 30, (s, s, 3))
        return {"image": np.clip(img, 0, 255).astype(np.uint8),
                "label": label}


def make_labeled_dataset(root: Optional[str] = None, train: bool = True,
                         synthetic_length: int = 256, image_size: int = 32):
    """CIFAR-10 when the local files exist, the synthetic set otherwise."""
    if root:
        try:
            return CIFAR10Dataset(root, train=train)
        except FileNotFoundError:
            pass
    return SyntheticLabeledDataset(length=synthetic_length,
                                   image_size=image_size)
