"""Metric sweep of a trained flagship checkpoint (256² operating point).

Counterpart of the JAX package's `scripts/eval_flagship.py` (:27-106): the
same flags, the same `Config` (plus `device`), `train/loop.py::evaluate` on
the synthetic paired split, and the same summary JSON (non-finite values,
such as fid without --fid, dropped). Scores a checkpoint directory or a
params npz (`export_params`'s, or the committed ones in docs/assets/).

    python -m hybrid_diffusion_tpu_torch.scripts.eval_flagship \
        --ckpt docs/assets/flagship256_r5_fp16.npz --sampler dpm++2m \
        --ddim_steps 5 [--untrained] [--out FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time


def summarize(results: dict) -> dict:
    """evaluate()'s {domain: {metric: value}} rounded to 3 places, the
    non-finite values dropped (bare NaN tokens are not strict JSON)."""
    return {d: {k: round(float(v), 3) for k, v in r.items()
                if math.isfinite(float(v))}
            for d, r in results.items()}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir or params npz (omit with "
                        "--untrained for the floor)")
    p.add_argument("--untrained", action="store_true",
                   help="random-init floor eval instead of a checkpoint")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--channel", type=int, default=128)
    p.add_argument("--channel_mult", type=int, nargs="+", default=[1, 2, 2, 2])
    p.add_argument("--num_res_blocks", type=int, default=2)
    p.add_argument("--T", type=int, default=1000)
    p.add_argument("--synthetic_length", type=int, default=512)
    p.add_argument("--sampler", default="",
                   help='"" = DDIM (reference); "dpm++2m" = fast sampler')
    p.add_argument("--ddim_steps", type=int, default=100)
    p.add_argument("--guidance", type=float, default=1.0,
                   help="classifier-free guidance scale w of the cemb path "
                        "(meaningful only for weights trained with "
                        "--use_conditioning)")
    p.add_argument("--use_conditioning", action="store_true",
                   help="weights were trained with the live cemb path: "
                        "sample conditionally at w=1")
    p.add_argument("--split", default="val")
    p.add_argument("--fid", action="store_true",
                   help="also compute FID (random-init Inception features "
                        "unless HDT_INCEPTION_WEIGHTS is set)")
    p.add_argument("--save_images", action="store_true")
    p.add_argument("--out_dir", default="output/demo256/eval")
    p.add_argument("--out", default=None, help="write JSON summary here")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default) or "cpu"')
    args = p.parse_args()
    if not args.ckpt and not args.untrained:
        p.error("need --ckpt or --untrained")

    from ..config import Config
    from ..train.loop import evaluate

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
        ddim_step=args.ddim_steps,
        sampler=args.sampler,
        unconditional_guidance_scale=args.guidance,
        use_conditioning=args.use_conditioning,
        pretrained_path=args.ckpt,
        output_path=args.out_dir,
        # No effect in the port; set as the JAX script sets it, so that the
        # two tools build the same configuration.
        compilation_cache=os.environ.get("JAX_COMPILATION_CACHE_DIR",
                                         ".jax_cache"),
        device=args.device,
    )
    t0 = time.time()
    results = evaluate(config, split=args.split, compute_fid=args.fid,
                       save_images=args.save_images)
    summary = {
        "checkpoint": args.ckpt,
        "sampler": args.sampler or "ddim",
        "steps": args.ddim_steps,
        "guidance": args.guidance,
        "results": summarize(results),
        "eval_wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
