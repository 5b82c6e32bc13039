"""Compose a (degraded | enhanced | ground-truth) preview grid.

Counterpart of the JAX package's `scripts/make_preview_grid.py`: pairs an
evaluation output directory (`evaluate(save_images=True)` writes enhanced
images under the originals' names) with the dataset that produced them,
and writes one PNG: a row an image, columns input | enhanced | GT. The
images are read with rescore_metrics.read_image, an enhanced image of
another size is resized with the port's bilinear resize
(data/registry.py::resize_image), and the PNG is written with the standard
library's writer: no cv2 or PIL. Host only, no device.

    python -m hybrid_diffusion_tpu_torch.scripts.make_preview_grid \
        --results out/result/synthetic-underwater/val \
        --dataset synthetic-underwater --split val --size 128 \
        --synthetic_length 512 --rows 6 --out grid.png
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--results", required=True,
                   help="dir of enhanced images (evaluate output)")
    p.add_argument("--dataset", required=True)
    p.add_argument("--split", default="val")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--synthetic_length", type=int, default=64)
    p.add_argument("--dataset_path", default="./data/")
    p.add_argument("--rows", type=int, default=6)
    p.add_argument("--out", default="preview_grid.png")
    args = p.parse_args()
    if not args.out.lower().endswith(".png"):
        p.error(f"--out {args.out}: the grid is written as a PNG")

    from ..data import make_dataset
    from ..data.registry import _png_bytes, resize_image
    from .rescore_metrics import read_image

    ds = make_dataset(args.dataset, task=args.split,
                      dataset_path=args.dataset_path,
                      image_size=args.size,
                      synthetic_length=args.synthetic_length)
    rows = []
    for i in range(min(args.rows, len(ds))):
        item = ds[i]
        enhanced_path = os.path.join(args.results, item["name"])
        if not os.path.exists(enhanced_path):
            continue
        enh = read_image(enhanced_path)
        if enh.shape[:2] != (args.size, args.size):
            enh = resize_image(enh, args.size)
        rows.append(np.concatenate([item["input"], enh, item["gt"]], axis=1))
    if not rows:
        print(f"no pairs found under {args.results}", file=sys.stderr)
        return 1
    grid = np.concatenate(rows, axis=0)
    with open(args.out, "wb") as f:
        f.write(_png_bytes(grid))
    print(f"wrote {args.out} ({len(rows)} rows: input | enhanced | gt)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
