"""Serving: a warm, fixed-shape enhancement endpoint on the card.

Counterpart of `hybrid_diffusion_tpu/serve.py::Enhancer` (:36-87):

  - weights load once, from a flat params npz, and stay on the device;
  - every device call runs ONE padded batch shape (`max_batch`); short
    batches are padded;
  - a warm-up call at construction builds the kernel and primes the caches;
  - uint8 NHWC images in, uint8 NHWC images out; inputs of any size are
    resized on the host to `img_size` by the native batch resizer
    (data/native.py, bilinear) and the outputs back to each input's size;
  - an fp32 Enhancer (bf16=False) samples with TF32 off and the caller's
    TF32 flags restored after each call (utils/precision.py).

Usage:
    enh = Enhancer(flagship_config(), "docs/assets/flagship256_r5_fp16.npz")
    out = enh.enhance(images)           # list[HWC uint8] -> list[HWC uint8]
    out = enh.enhance_paths(["a.png"])  # files -> arrays
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from .config import Config
from .data.native import BILINEAR, batch_resize
from .train.loop import build_model, make_sampler
from .utils.device import resolve_device
from .weights import load_npz_state_dict


class Enhancer:
    """Warm single-shape enhancement service over npz weights."""

    def __init__(self, config: Config, npz_path, max_batch: int = 8,
                 warmup: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.max_batch = max_batch
        self.size = config.img_size
        model = build_model(config)
        model.load_state_dict(load_npz_state_dict(npz_path), strict=True)
        self._model = model.to(self.device).eval()
        self._sample = make_sampler(config, self._model, quantize_uint8=True)
        self._generator = torch.Generator(self.device).manual_seed(config.seed)
        self.device_calls = 0
        if warmup:
            self._run(np.zeros((max_batch, self.size, self.size, 3), np.uint8))

    def _run(self, batch_u8: np.ndarray) -> np.ndarray:
        """One padded fixed-shape device call. batch_u8: (≤max_batch,S,S,3)."""
        n = batch_u8.shape[0]
        if n < self.max_batch:
            pad = np.zeros((self.max_batch - n, self.size, self.size, 3),
                           np.uint8)
            batch_u8 = np.concatenate([batch_u8, pad])
        x = torch.from_numpy(batch_u8).to(self.device)
        out = self._sample(x, self._generator)
        self.device_calls += 1
        return out[:n].cpu().numpy()

    def enhance(self, images: Sequence[np.ndarray]) -> list[np.ndarray]:
        """Enhance HWC uint8 images of any sizes; outputs match inputs'
        original sizes (the model runs at config.img_size)."""
        if not len(images):
            return []
        sizes = [im.shape[:2] for im in images]
        batch = batch_resize(list(images), (self.size, self.size), BILINEAR)
        outs: list[np.ndarray] = []
        for lo in range(0, len(images), self.max_batch):
            outs.extend(self._run(batch[lo: lo + self.max_batch]))
        return [
            batch_resize([o], (h, w), BILINEAR)[0] if (h, w) != o.shape[:2]
            else o
            for o, (h, w) in zip(outs, sizes)
        ]

    def enhance_paths(self, paths: Sequence[str],
                      output_dir: Optional[str] = None) -> list[np.ndarray]:
        """Enhance image files; optionally write enhanced_<name> files."""
        from .data.registry import load_image, save_image

        outs = self.enhance([load_image(p) for p in paths])
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            for p, o in zip(paths, outs):
                save_image(os.path.join(output_dir,
                                        f"enhanced_{os.path.basename(p)}"), o)
        return outs
