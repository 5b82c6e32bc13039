"""Standalone folder-vs-folder metric harness.

The port's counterpart of `hybrid_diffusion_tpu/metrics/__main__.py`
(:34-118), reading images with the port's `data.registry.load_image`.

Rebuilds the reference's ad-hoc evaluator (`python metrics/metrics.py`
→ metrics.py:609-668): walk a results folder against a GT folder, compute
UIQM/UCIQE/UISM + PSNR/SSIM per image with per-image exception shielding
(metrics.py:632-645), and print folder averages.

Divergences from the reference (recorded):
  - files are paired by *filename stem intersection*, not by raw
    `os.listdir` zip order (metrics.py:620-626 pairs OS-enumeration order —
    nondeterministic, and one extra/missing file misaligns every pair
    after it); unmatched files are reported, never silently dropped;
  - paths come from argv instead of a hardcoded list (metrics.py:611-614);
  - the report file the reference left commented out (metrics.py:662-666)
    is available via --report.

Usage:
    python -m hybrid_diffusion_tpu_torch.metrics RESULTS_DIR GT_DIR [--report F]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import nmetrics, psnr, ssim_index

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def _list_images(directory: str) -> list[str]:
    return sorted(
        f for f in os.listdir(directory)
        if f.lower().endswith(IMAGE_EXTS)
    )


def evaluate_folders(result_path: str, gt_path: str) -> dict:
    """Average metrics over paired (result, gt) images; shields per-image
    failures like the reference harness (metrics.py:632-645)."""
    from ..data.registry import load_image

    result_files = _list_images(result_path)
    gt_files = _list_images(gt_path)
    # Pair by filename stem (extension-insensitive: result.png vs gt.jpg
    # still match). Positional zip of two sorted listings would misalign
    # every pair after one extra/missing file.
    res_by_stem = {os.path.splitext(f)[0]: f for f in result_files}
    gt_by_stem = {os.path.splitext(f)[0]: f for f in gt_files}
    stems = sorted(set(res_by_stem) & set(gt_by_stem))
    unmatched = (set(res_by_stem) | set(gt_by_stem)) - set(stems)
    if unmatched:
        print(f"warning: {len(unmatched)} file(s) without a partner "
              f"skipped: {sorted(unmatched)[:5]}"
              + (" ..." if len(unmatched) > 5 else ""))
    pairs = [(res_by_stem[s], gt_by_stem[s]) for s in stems]
    sums = dict(uiqm=0.0, uciqe=0.0, uism=0.0, psnr=0.0, ssim=0.0)
    n = 0
    for res_name, gt_name in pairs:
        try:
            corrected = load_image(os.path.join(result_path, res_name))
            gt_image = load_image(os.path.join(gt_path, gt_name))
        except Exception as e:
            print(f"error loading image pair ({res_name}, {gt_name}): {e}")
            continue
        try:
            if corrected.shape != gt_image.shape:
                raise ValueError(
                    f"shape mismatch {corrected.shape} vs {gt_image.shape}")
            # uint8 0-255 (reference metrics.py:609-668 walks saved files
            # the same way; the UIQM family is range-sensitive).
            uiqm_v, uciqe_v, uism_v, _, _ = nmetrics(corrected)
            psnr_v = psnr(gt_image, corrected, data_range=255)
            ssim_v = ssim_index(gt_image, corrected, data_range=255)
        except Exception as e:
            print(f"error computing metrics for {res_name}: {e}")
            continue
        sums["uiqm"] += uiqm_v
        sums["uciqe"] += uciqe_v
        sums["uism"] += uism_v
        sums["psnr"] += psnr_v
        sums["ssim"] += ssim_v
        n += 1
    if n == 0:
        raise SystemExit(
            f"no evaluable image pairs in {result_path} vs {gt_path}")
    out = {k: v / n for k, v in sums.items()}
    out["n"] = n
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m hybrid_diffusion_tpu_torch.metrics",
        description=__doc__.split("\n\n")[0])
    p.add_argument("result_path", help="folder of enhanced/result images")
    p.add_argument("gt_path", help="folder of ground-truth images "
                   "(paired by filename stem)")
    p.add_argument("--report", default=None,
                   help="append the averages line to this text file")
    args = p.parse_args(argv)

    res = evaluate_folders(args.result_path, args.gt_path)
    line = (f"Average (n={res['n']}): uiqm={res['uiqm']:.4f} "
            f"uciqe={res['uciqe']:.4f} uism={res['uism']:.4f} "
            f"psnr={res['psnr']:.4f} ssim={res['ssim']:.4f}")
    print(line)
    if args.report:
        with open(args.report, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
