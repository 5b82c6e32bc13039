"""CFG demo: train the label-conditioned DDPM briefly, then sweep the
guidance scale and measure its effect, on the card.

Counterpart of the JAX package's `scripts/demo_cfg.py`: `train_cfg` at
the reference's operating point, the trained parameters persisted as
`<keep>/cfg_params.npz` in the JAX package's flat layout (so that either
package's `regen_cfg_grids` reads them), then one sampler
(`cfg_ddpm_sample`, the full T-step chain) for every w of the sweep,
writing a label-grid PNG per w.

Quantitative signal: the synthetic labeled corpus (cfg/data.py) gives
each class a deterministic hue × spatial-frequency template, so each
sample is classified by its nearest noise-free class template; guidance
should raise that accuracy with w. Exits 0 when the best guided accuracy
is strictly above w = 0's (and w = 0's is below 1), else 1.

    python -m hybrid_diffusion_tpu_torch.scripts.demo_cfg [--steps 6000] \
        [--ws 0,0.5,1.8,3.0] [--out FILE] [--keep DIR] [--load_npz P.npz] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np


def class_templates(image_size: int) -> np.ndarray:
    """Noise-free per-class images mirroring SyntheticLabeledDataset."""
    s = image_size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    out = np.zeros((10, s, s, 3), np.float32)
    for label in range(10):
        hue = np.array([(label * 25 % 255), (label * 97 % 255),
                        (label * 161 % 255)], np.float32)
        freq = 1.0 + label
        pattern = 0.5 + 0.5 * np.sin(2 * np.pi * freq * (yy + xx))[..., None]
        # The dataset adds uniform(0, 30) noise before the uint8 clip; its
        # mean (+15) is part of the class signal the model learns.
        out[label] = np.clip(hue * pattern + 15.0, 0, 255)
    return out


def template_accuracy(imgs: np.ndarray, labels: np.ndarray,
                      templates: np.ndarray) -> tuple[float, float]:
    """(nearest-template accuracy, mean L2 distance to the true template)."""
    x = imgs.astype(np.float32)                      # (N, H, W, 3)
    d = ((x[:, None] - templates[None]) ** 2).mean(axis=(2, 3, 4))  # (N, 10)
    pred = d.argmin(axis=1)
    acc = float((pred == labels).mean())
    true_d = float(np.sqrt(d[np.arange(len(labels)), labels]).mean())
    return acc, true_d


def to_uint8(out) -> np.ndarray:
    """Samples in [-1, 1] (a tensor) -> uint8 images, as the JAX script
    quantizes them."""
    imgs = (out.float().cpu().numpy() + 1.0) / 2.0 * 255.0
    return imgs.clip(0, 255).astype(np.uint8)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=6000)
    p.add_argument("--epochs", type=int, default=10_000)
    p.add_argument("--channel", type=int, default=128)
    p.add_argument("--T", type=int, default=500)
    p.add_argument("--batch", type=int, default=80)
    p.add_argument("--img_size", type=int, default=32)
    p.add_argument("--synthetic_length", type=int, default=2000)
    p.add_argument("--nrow", type=int, default=8)
    p.add_argument("--ws", default="0,0.5,1.8,3.0")
    p.add_argument("--data_root", default=None,
                   help="local CIFAR-10 dir (default: synthetic fixture)")
    p.add_argument("--out", default=None)
    p.add_argument("--keep", default=None)
    p.add_argument("--load_npz", default=None,
                   help="skip training: load params from a cfg_params.npz "
                        "persisted by a previous run (same config)")
    p.add_argument("--chunk_rows", type=int, default=0,
                   help="sample each w in chunks of this many rows "
                        "(10*chunk_rows images a call); 0 = one call per w")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default) or "cpu"')
    args = p.parse_args()

    import torch

    from ..cfg.sampler import cfg_ddpm_sample
    from ..cfg.train import (CFGConfig, _image_grid, _write_png,
                             init_cfg_model, train_cfg)
    from ..diffusion.schedule import linear_beta_schedule
    from ..utils.device import resolve_device
    from ..utils.precision import precision_for
    from ..weights import flat_from_state_dict, load_npz_state_dict

    tmp = args.keep or tempfile.mkdtemp(prefix="hdt_cfg_demo_")
    os.makedirs(tmp, exist_ok=True)
    ws = [float(w) for w in args.ws.split(",")]
    config = CFGConfig(
        epochs=args.epochs,
        batch_size=args.batch,
        T=args.T,
        channel=args.channel,
        img_size=args.img_size,
        nrow=args.nrow,
        synthetic_length=args.synthetic_length,
        data_root=args.data_root,
        save_dir=os.path.join(tmp, "ckpt"),
        sampled_dir=tmp,
        save_every=10_000,  # the demo keeps only in-memory params
        device=args.device,
    )
    device = resolve_device(config.device)
    summary: dict = {"config": {
        "steps": args.steps, "T": args.T, "channel": args.channel,
        "batch": args.batch, "img_size": args.img_size, "ws": ws,
    }}

    if args.load_npz:
        # Sampling-only rerun on persisted params: same config, no training.
        params = load_npz_state_dict(args.load_npz)
        summary["train"] = {"loaded_npz": args.load_npz}
        print(f"# loaded params from {args.load_npz} (training skipped)",
              file=sys.stderr)
    else:
        t0 = time.time()
        result = train_cfg(config, max_steps=args.steps)
        params = result["params"]
        summary["train"] = {
            "steps": result["steps"],
            "first_loss": round(result["losses"][0], 4),
            "last_loss": round(result["losses"][-1], 4),
            "wall_s": round(time.time() - t0, 1),
        }
        print(f"# trained {result['steps']} steps in "
              f"{summary['train']['wall_s']}s loss "
              f"{result['losses'][0]:.4f} -> {result['losses'][-1]:.4f}",
              file=sys.stderr)
        # The trained params in the JAX package's flat layout (its
        # regen_cfg_grids and this package's both read them).
        np.savez(os.path.join(tmp, "cfg_params.npz"),
                 **flat_from_state_dict(params))

    model = init_cfg_model(dataclasses.replace(config, dropout=0.0), device)
    model.load_state_dict(dict(params), strict=True)
    model.eval()
    schedule = linear_beta_schedule(config.beta_1, config.beta_T, config.T)
    chunk_rows = args.chunk_rows or config.nrow
    if config.nrow % chunk_rows:
        raise SystemExit(f"--nrow {config.nrow} must be divisible by "
                         f"--chunk_rows {chunk_rows}")
    n_chunks = config.nrow // chunk_rows
    chunk_labels_np = np.repeat(np.arange(1, 11), chunk_rows)  # +1-shifted
    labels = torch.as_tensor(chunk_labels_np, device=device)

    templates = class_templates(config.img_size)
    summary["sweep"] = []
    for i, w in enumerate(ws):
        t0 = time.time()
        chunks = []
        for c in range(n_chunks):
            gen = torch.Generator(device).manual_seed(1234 + 7919 * c)
            with precision_for(config.bf16):
                out = cfg_ddpm_sample(model, schedule, labels, gen,
                                      image_size=config.img_size, w=w)
            chunks.append(to_uint8(out))
        wall = time.time() - t0
        # Row-major per class across chunks: class k's rows are the k-th
        # blocks of every chunk, so labels repeat the chunk pattern.
        imgs = np.concatenate(chunks, axis=0)
        labels_np = np.tile(chunk_labels_np, n_chunks)
        acc, dist = template_accuracy(imgs, labels_np - 1, templates)
        png = os.path.join(tmp, f"cfg_grid_w{w:g}.png")
        # Group the grid by class (chunked sampling interleaves classes).
        order = np.argsort(labels_np, kind="stable")
        _write_png(png, _image_grid(imgs[order], config.nrow))
        n_samp = len(labels_np)
        # 95% binomial CI (normal approximation).
        se = float(np.sqrt(max(acc * (1 - acc), 1e-12) / n_samp))
        entry = {"w": w, "template_accuracy": round(acc, 4),
                 "n": n_samp, "acc_ci95": round(1.96 * se, 4),
                 "template_dist": round(dist, 2),
                 "sample_wall_s": round(wall, 1), "grid": png}
        summary["sweep"].append(entry)
        print(f"# w={w:g}: acc={acc:.3f} dist={dist:.1f} {wall:.1f}s",
              file=sys.stderr)

    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    # Guidance must STRICTLY improve over w = 0.
    by_w = {e["w"]: e["template_accuracy"] for e in summary["sweep"]}
    positives = [v for w, v in by_w.items() if w > 0]
    if not positives:
        print("# no guided (w>0) runs in the sweep — nothing to compare",
              file=sys.stderr)
        return 0
    guided = max(positives)
    unguided = by_w.get(0.0, 0.0)
    # Two-proportion z-test between the best guided point and w = 0.
    n_pt = summary["sweep"][0]["n"]
    pooled_se = float(np.sqrt(
        max(guided * (1 - guided), 1e-12) / n_pt
        + max(unguided * (1 - unguided), 1e-12) / n_pt))
    z = (guided - unguided) / pooled_se if pooled_se else float("inf")
    summary["guidance_lift"] = {
        "best_guided": guided, "unguided": unguided, "n_per_point": n_pt,
        "z": round(z, 2), "significant_95": bool(z > 1.96)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    print(f"# guided acc {guided:.3f} vs unguided {unguided:.3f} "
          f"(z={z:.2f}, {'significant' if z > 1.96 else 'NOT significant'} "
          f"at 95%, n={n_pt}/point)", file=sys.stderr)
    if unguided >= 1.0:
        print("# NON-DISCRIMINATIVE: unguided accuracy is saturated — "
              "rerun with a shorter --steps budget so the sweep can show "
              "the guidance effect", file=sys.stderr)
        return 1
    return 0 if guided > unguided else 1


if __name__ == "__main__":
    sys.exit(main())
