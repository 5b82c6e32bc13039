"""Sampler/NFE quality sweep over a trained checkpoint.

Counterpart of the JAX package's `scripts/sweep_sampler.py` (:27-88): one
`evaluate()` a `sampler:steps` point against one set of weights, a JSON row
printed for each, and the consolidated table written to --out.

    python -m hybrid_diffusion_tpu_torch.scripts.sweep_sampler \
        --ckpt docs/assets/flagship256_r5_fp16.npz \
        --points dpm++2m:5 dpm++2m:10 ddim:100 --out sweep.json [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .eval_flagship import summarize


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--points", nargs="+", default=[
        "dpm++2m:5", "dpm++2m:10", "dpm++2m:15", "ddim:100"],
        help="sampler:steps grid points")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--channel", type=int, default=128)
    p.add_argument("--channel_mult", type=int, nargs="+", default=[1, 2, 2, 2])
    p.add_argument("--num_res_blocks", type=int, default=2)
    p.add_argument("--T", type=int, default=1000)
    p.add_argument("--synthetic_length", type=int, default=512)
    p.add_argument("--split", default="val")
    p.add_argument("--fid", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default) or "cpu"')
    args = p.parse_args()

    from ..config import Config
    from ..train.loop import evaluate

    rows = []
    for point in args.points:
        sampler, steps = point.rsplit(":", 1)
        config = Config(
            state="eval",
            synthetic_data=True,
            synthetic_length=args.synthetic_length,
            img_size=args.size,
            batch_size=args.batch,
            channel=args.channel,
            channel_mult=args.channel_mult,
            num_res_blocks=args.num_res_blocks,
            T=args.T,
            dropout=0.0,
            ddim=True,
            ddim_step=int(steps),
            sampler="" if sampler == "ddim" else sampler,
            pretrained_path=args.ckpt,
            output_path="output/sweep/eval",
            # No effect in the port; set as the JAX script sets it.
            compilation_cache=os.environ.get("JAX_COMPILATION_CACHE_DIR",
                                             ".jax_cache"),
            device=args.device,
        )
        t0 = time.time()
        results = evaluate(config, split=args.split, compute_fid=args.fid,
                           save_images=False)
        rows.append({
            "sampler": sampler,
            "steps": int(steps),
            "results": summarize(results),
            "eval_wall_s": round(time.time() - t0, 1),
        })
        print(json.dumps(rows[-1]), flush=True)

    summary = {"checkpoint": args.ckpt, "split": args.split, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
