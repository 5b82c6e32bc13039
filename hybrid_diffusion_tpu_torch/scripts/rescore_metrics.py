"""Re-score saved eval result images against the synthetic GT fixture.

Counterpart of the JAX package's `scripts/rescore_metrics.py`: reads the
images `evaluate(save_images=True)` wrote (result/<dataset>/<split>/
<name>.png), pairs them by name with the synthetic corpus's GT, recomputes
PSNR, SSIM and the UIQM family on 0-255 uint8 images without sampling
again, prints and appends a `res.txt` line per domain, and writes the JSON
table to --out. Host only: numpy metrics, no device. The images are read
with `read_image`, which needs no cv2 or PIL for a PNG.

    python -m hybrid_diffusion_tpu_torch.scripts.rescore_metrics \
        --root output/demo256/eval/result --size 256 \
        --synthetic_length 512 [--split val] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def read_image(path: str) -> np.ndarray:
    """An image file as RGB uint8 HWC, through serve_http's decoders: the
    native library, cv2, PIL, and the standard library's PNG decoder on a
    host with none of them."""
    from ..serve_http import _decode_any

    with open(path, "rb") as f:
        img = _decode_any(f.read())
    if img is None:
        raise ValueError(f"cannot decode image {path}")
    return img


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="output/demo256/out/result")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--synthetic_length", type=int, default=512)
    p.add_argument("--split", default="val")
    p.add_argument("--out", default=None)
    args = p.parse_args()

    from ..data import make_dataset
    from ..metrics import getUIQM, nmetrics, psnr, ssim_index

    results = {}
    for domain in ("underwater", "atmospheric"):
        res_dir = os.path.join(args.root, f"synthetic-{domain}", args.split)
        if not os.path.isdir(res_dir):
            continue
        ds = make_dataset(f"synthetic-{domain}", task=args.split,
                          image_size=args.size,
                          synthetic_length=args.synthetic_length)
        gt_by_name = {}
        for i in range(len(ds)):
            ex = ds[i]
            gt_by_name[ex["name"]] = ex["gt"]
        sums = dict(psnr=0.0, ssim=0.0, uiqm=0.0, uciqe=0.0, uism=0.0,
                    uicm=0.0, uiconm=0.0, uiqm_nd=0.0)
        n = 0
        for name in sorted(os.listdir(res_dir)):
            if name not in gt_by_name:
                print(f"warning: no GT for {name}, skipped")
                continue
            img = read_image(os.path.join(res_dir, name))
            gt = gt_by_name[name]
            sums["psnr"] += psnr(gt, img, data_range=255)
            sums["ssim"] += ssim_index(gt, img, data_range=255)
            uiqm_v, uciqe_v, uism_v, uicm_v, uiconm_v = nmetrics(img)
            sums["uiqm"] += uiqm_v
            sums["uciqe"] += uciqe_v
            sums["uism"] += uism_v
            sums["uicm"] += uicm_v
            sums["uiconm"] += uiconm_v
            sums["uiqm_nd"] += getUIQM(img)
            n += 1
        res = {k: round(v / max(n, 1), 4) for k, v in sums.items()}
        res["n_images"] = n
        results[domain] = res
        line = (f"split={args.split} n={n} (rescored, 0-255 UIQM fix) "
                + " ".join(f"{k}={v:.4f}" for k, v in res.items()
                           if isinstance(v, float)))
        print(f"[{domain}] {line}")
        report = os.path.join(args.root, f"synthetic-{domain}", "res.txt")
        with open(report, "a") as f:
            f.write(line + "\n")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return 0 if results else 1


if __name__ == "__main__":
    sys.exit(main())
