"""Export a trained checkpoint's parameters to a single flat .npz.

Counterpart of the JAX package's `scripts/export_params.py` (:46-118): a
port checkpoint directory (train/checkpoint.py) or a flat params npz in,
one compressed npz in the JAX package's flat layout out
(`weights.save_npz_state_dict`), which the JAX `restore_params` /
`load_params_npz`, the port's `--pretrained_path` and `eval_flagship`
read; beside it an `<out>.json` sidecar (subtree, reason, step, ema_decay,
source).

``--subtree auto`` (default) applies the EMA-maturity rule
(train/checkpoint.py::choose_restore_subtree): the EMA is exported only
when the checkpoint's probe or decay^step says it samples best, else the
raw parameters. ``ema``/``raw`` force a subtree (train/checkpoint.py::
restore_partial); a flat npz holds one subtree already, so forcing one for
an npz input is an error (exit 2).

The parameters are loaded into the DynamicUNet of --size/--channel/...,
strictly, so a file of another configuration is refused here and not at
the first eval.

    python -m hybrid_diffusion_tpu_torch.scripts.export_params \
        --ckpt output/ckpt/ckpt_... --out w.npz
    python -m hybrid_diffusion_tpu_torch.scripts.eval_flagship --ckpt w.npz

Verify before shipping: evaluate the exported file itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True,
                   help="checkpoint dir or flat params npz")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--dtype", default="float16",
                   choices=["float16", "float32"],
                   help="export precision (fp16 is lossless w.r.t. the "
                        "bf16 compute path; see utils/params_io.py)")
    p.add_argument("--subtree", default="auto",
                   choices=["auto", "ema", "raw"],
                   help="auto = EMA-maturity rule; ema/raw force a subtree")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--channel", type=int, default=128)
    p.add_argument("--channel_mult", type=int, nargs="+", default=[1, 2, 2, 2])
    p.add_argument("--num_res_blocks", type=int, default=2)
    p.add_argument("--T", type=int, default=1000)
    args = p.parse_args()

    from ..models import DynamicUNet
    from ..train.checkpoint import (choose_restore_subtree, load_metadata,
                                    restore_params, restore_partial)
    from ..weights import save_npz_state_dict

    # --size shapes no parameter (the JAX script's template takes it).
    model = DynamicUNet(T=args.T, ch=args.channel,
                        ch_mult=tuple(args.channel_mult),
                        num_res_blocks=args.num_res_blocks, dropout=0.0)
    is_npz = args.ckpt.endswith(".npz")
    if is_npz:
        if args.subtree != "auto":
            p.error(f"--subtree {args.subtree} cannot be honored for a flat "
                    ".npz input (it holds a single already-selected "
                    "subtree); re-export from the checkpoint dir")
        subtree, reason = "npz", "flat npz re-export"
        restore_params(args.ckpt, model)
    elif args.subtree == "auto":
        subtree, reason = choose_restore_subtree(args.ckpt)
        restore_params(args.ckpt, model)
    else:
        subtree = {"ema": "ema_params", "raw": "params"}[args.subtree]
        reason = f"forced --subtree {args.subtree}"
        saved = restore_partial(args.ckpt, ("params", subtree))
        if subtree not in saved:
            p.error(f"{args.ckpt} holds no {subtree}")
        # As restore_params loads an EMA: over the raw parameters.
        model.load_state_dict({**saved["params"], **saved[subtree]},
                              strict=True)
    state = model.state_dict()
    n = sum(t.numel() for t in state.values())
    save_npz_state_dict(args.out, state, dtype=args.dtype)
    meta = {} if is_npz else load_metadata(args.ckpt)
    with open(args.out + ".json", "w") as f:
        json.dump({"subtree": subtree, "reason": reason,
                   "step": meta.get("step"),
                   "ema_decay": meta.get("ema_decay"),
                   "source": os.path.abspath(args.ckpt)}, f)
    mb = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out}: {n / 1e6:.1f}M params, {mb:.1f} MB "
          f"({args.dtype}, compressed)")
    print(f"exported subtree: {subtree} — {reason}")
    print(f"VERIFY BEFORE SHIPPING: python -m hybrid_diffusion_tpu_torch."
          f"scripts.eval_flagship --ckpt {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
