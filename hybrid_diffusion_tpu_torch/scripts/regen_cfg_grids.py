"""Regenerate the CFG sweep grids from a persisted cfg_params.npz, without
training again.

Counterpart of the JAX package's `scripts/regen_cfg_grids.py`: reads the
flat npz that either package's `demo_cfg` writes (`<keep>/cfg_params.npz`,
the JAX flat layout) through `weights.state_dict_from_flat` into a
CFGUNet, reruns the guidance sweep (the full T-step chain for every w, the
noise from a generator seeded 1234 on the device), and writes a grid PNG
per w and the JSON summary.

    python -m hybrid_diffusion_tpu_torch.scripts.regen_cfg_grids \
        --params output/cfg_demo/cfg_params.npz [--ws 0,0.5,1.8,3.0] \
        [--out FILE] [--keep DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .demo_cfg import class_templates, template_accuracy, to_uint8


def load_cfg_model(params_path: str, config):
    """The CFGUNet of `config` on its device, in eval mode, its weights
    read from a flat params npz (`demo_cfg`'s cfg_params.npz, the JAX
    package's layout) through weights.state_dict_from_flat."""
    from ..cfg.train import init_cfg_model
    from ..utils.device import resolve_device
    from ..weights import load_npz_state_dict

    model = init_cfg_model(config, resolve_device(config.device))
    model.load_state_dict(load_npz_state_dict(params_path), strict=True)
    return model.eval()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--params", required=True, help="cfg_params.npz")
    p.add_argument("--channel", type=int, default=128)
    p.add_argument("--T", type=int, default=500)
    p.add_argument("--img_size", type=int, default=32)
    p.add_argument("--nrow", type=int, default=8)
    p.add_argument("--ws", default="0,0.5,1.8,3.0")
    p.add_argument("--out", default=None)
    p.add_argument("--keep", default=None,
                   help="output dir (default: the npz's directory)")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default) or "cpu"')
    args = p.parse_args()

    import torch

    from ..cfg.sampler import cfg_ddpm_sample
    from ..cfg.train import CFGConfig, _image_grid, _write_png
    from ..diffusion.schedule import linear_beta_schedule
    from ..utils.precision import precision_for

    out_dir = args.keep or os.path.dirname(os.path.abspath(args.params))
    os.makedirs(out_dir, exist_ok=True)
    config = CFGConfig(T=args.T, channel=args.channel,
                       img_size=args.img_size, nrow=args.nrow, dropout=0.0,
                       device=args.device)
    model = load_cfg_model(args.params, config)
    device = next(model.parameters()).device
    schedule = linear_beta_schedule(config.beta_1, config.beta_T, config.T)
    labels_np = np.repeat(np.arange(1, 11), config.nrow)
    labels = torch.as_tensor(labels_np, device=device)

    templates = class_templates(config.img_size)
    summary = {"params": args.params, "sweep": []}
    for w in (float(v) for v in args.ws.split(",")):
        t0 = time.time()
        gen = torch.Generator(device).manual_seed(1234)
        with precision_for(config.bf16):
            out = cfg_ddpm_sample(model, schedule, labels, gen,
                                  image_size=config.img_size, w=w)
        imgs = to_uint8(out)
        acc, dist = template_accuracy(imgs, labels_np - 1, templates)
        png = os.path.join(out_dir, f"cfg_grid_w{w:g}.png")
        _write_png(png, _image_grid(imgs, config.nrow))
        summary["sweep"].append(
            {"w": w, "template_accuracy": round(acc, 4),
             "template_dist": round(dist, 2),
             "sample_wall_s": round(time.time() - t0, 1), "grid": png})
        print(f"# w={w:g}: acc={acc:.3f} dist={dist:.1f}", file=sys.stderr)

    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
