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

`export_enhancer` / `load_exported` (the counterpart of :109-152) save the
warm Enhancer's whole program, weights and sampler loop included, as a
`torch.export` artifact, uint8 in and uint8 out, that another process loads
with `import hybrid_diffusion_tpu_torch` alone (for the attention op).

Usage:
    enh = Enhancer(flagship_config(), "docs/assets/flagship256_r5_fp16.npz")
    out = enh.enhance(images)           # list[HWC uint8] -> list[HWC uint8]
    out = enh.enhance_paths(["a.png"])  # files -> arrays
    data = export_enhancer(enh, "enhancer.pt2")
    run = load_exported(data)           # run(batch_u8, generator) -> uint8
"""

from __future__ import annotations

import io
import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .config import Config
from .data.native import BILINEAR, batch_resize
from .train.loop import build_model, make_sampler
from .utils.device import resolve_device
from .utils.precision import precision_for
from .weights import load_npz_state_dict


class Enhancer:
    """Warm single-shape enhancement service over npz weights."""

    def __init__(self, config: Config, npz_path, max_batch: int = 8,
                 warmup: bool = True, device="cuda", mesh=None):
        """`mesh` (a parallel.make_mesh DeviceMesh; every rank constructs
        the Enhancer and calls it alike) shards each padded batch over its
        "data" axis, as the JAX Enhancer's does: max_batch must divide over
        it, and every rank returns the whole batch."""
        self.device = resolve_device(device)
        self.config = config
        self.max_batch = max_batch
        self.size = config.img_size
        model = build_model(config)
        model.load_state_dict(load_npz_state_dict(npz_path), strict=True)
        self._model = model.to(self.device).eval()
        self._sample = make_sampler(config, self._model, quantize_uint8=True,
                                    mesh=mesh)
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


class _EnhancerProgram(torch.nn.Module):
    """The Enhancer's device call as a module: (batch_u8, init_noise) ->
    uint8, the model a submodule so that export keeps its weights."""

    def __init__(self, enhancer: Enhancer):
        super().__init__()
        self.model = enhancer._model
        self._sample = enhancer._sample

    def forward(self, batch_u8: torch.Tensor,
                init_noise: torch.Tensor) -> torch.Tensor:
        return self._sample(batch_u8, None, init_noise)


_META = "hdt_enhancer.json"


def export_enhancer(enhancer: Enhancer, path=None) -> bytes:
    """Save the warm Enhancer's whole program as a `torch.export` artifact:
    the weights, the sampler loop (unrolled), the normalization and the
    uint8 quantization, at the fixed shape (max_batch, S, S, 3), on the
    Enhancer's device. The attention stays the op `hdt::attention_fwd`, so
    that the program launches the CUDA kernel on the card.

    torch.export takes no `torch.Generator`, so the program takes the
    initial noise as its second input; the callable of `load_exported`
    draws it from the caller's generator (the JAX export takes a key). The
    samplers that draw noise at every step (full-T DDPM) are not exported.

    Returns the artifact's bytes; writes them to `path` when given.
    """
    config = enhancer.config
    if config.sampler != "dpm++2m" and not config.ddim:
        raise ValueError("export_enhancer takes the deterministic samplers "
                         "(dpm++2m, ddim): full-T DDPM draws noise at every "
                         "step")
    shape = (enhancer.max_batch, enhancer.size, enhancer.size, 3)
    args = (torch.zeros(shape, dtype=torch.uint8, device=enhancer.device),
            torch.zeros(shape, dtype=torch.float32, device=enhancer.device))
    program = torch.export.export(_EnhancerProgram(enhancer), args)
    meta = {"shape": list(shape), "bf16": bool(config.bf16),
            "device": str(enhancer.device)}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
    data = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(data)
    return data


def load_exported(path_or_bytes) -> Callable[..., torch.Tensor]:
    """Load an `export_enhancer` artifact -> run(batch_u8, generator=None):
    batch_u8 a (max_batch, S, S, 3) uint8 tensor on the artifact's device,
    the initial noise drawn from `generator` (or the global generator); an
    fp32 artifact runs with TF32 off, as the Enhancer does."""
    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            path_or_bytes = f.read()
    extra = {_META: ""}
    program = torch.export.load(io.BytesIO(path_or_bytes), extra_files=extra)
    meta = json.loads(extra[_META])
    module = program.module()

    def run(batch_u8: torch.Tensor,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = torch.randn(meta["shape"], generator=generator,
                            device=batch_u8.device)
        with torch.no_grad(), precision_for(meta["bf16"]):
            return module(batch_u8, noise)

    run.meta = meta
    return run
