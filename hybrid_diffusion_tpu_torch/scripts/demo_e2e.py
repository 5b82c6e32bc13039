"""End-to-end demo: train → checkpoint → eval → report, on the card.

Counterpart of the JAX package's `scripts/demo_e2e.py`: runs the whole
stack (staged or joint training with EMA, checkpoints, DDIM sampling, the
metric sweep) on the synthetic paired corpus, small enough to finish in
minutes, and prints a JSON summary with the same keys:

  - the training's steps and last loss (learning signal),
  - PSNR/SSIM/UIQM/UCIQE of the enhanced val split,
  - PSNR/SSIM of an *untrained* model's samples (the floor) and of the
    degraded inputs themselves (the no-op enhancer baseline).

Exits 0 when training beat the untrained floor by more than 1 dB on both
domains (or with --skip_floor), else 1.

    python -m hybrid_diffusion_tpu_torch.scripts.demo_e2e [--steps 3000] \
        [--size 64] [--out FILE] [--keep DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def build_config(tmp: str, args) -> "Config":
    """The run's Config, as the JAX script builds it (plus `device`)."""
    from ..config import Config

    length = args.synthetic_length or args.batch * 8
    if args.staged:
        # The reference's two stages (atmospheric, then underwater), each
        # epoch one domain: length/batch steps.
        per_stage = max(args.steps // 2 // max(length // args.batch, 1), 1)
        stage_epochs = (per_stage, per_stage)
    else:
        # Joint training interleaves both loaders: 2·length/batch steps/epoch.
        stage_epochs = (max(
            args.steps // max(2 * length // args.batch, 1) + 1, 1), 0)
    return Config(
        state="train",
        synthetic_data=True,
        synthetic_length=length,
        img_size=args.size,
        batch_size=args.batch,
        channel=args.channel,
        channel_mult=args.channel_mult,
        num_res_blocks=args.num_res_blocks,
        T=args.T,
        dropout=args.dropout,
        lr=args.lr,
        # The warmup-cosine schedule ends at --steps.
        epochs_stage_1=stage_epochs[0],
        epochs_stage_2=stage_epochs[1],
        joint_training=not args.staged,
        stage1_losses=args.stage1_losses,
        stage2_losses=args.stage2_losses,
        # An EMA horizon of ~20 windows over the run.
        ema_decay=min(0.999, 1.0 - 20.0 / max(args.steps, 40)),
        ddim=True,
        ddim_step=args.ddim_steps,
        save_checkpoint=args.save_every,
        checkpoint_dir=os.path.join(tmp, "ckpt"),
        output_path=os.path.join(tmp, "out"),
        # No effect in the port; set as the JAX script sets it.
        compilation_cache=os.environ.get("JAX_COMPILATION_CACHE_DIR",
                                         ".jax_cache"),
        dino_weight=args.dino_weight,
        color_weight=args.color_weight,
        ms_ssim_weight=args.ms_ssim_weight,
        aux_snr_weight=args.aux_snr_weight,
        domain_routing=args.domain_routing,
        eval_every=args.eval_every,
        eval_probe_steps=args.eval_probe_steps,
        resume_from=args.resume_from,
        init_from_npz=args.init_from_npz,
        export_npz=args.export_npz,
        device_data=args.device_data,
        use_conditioning=args.use_conditioning,
        p_uncond=args.p_uncond,
        unconditional_guidance_scale=args.guidance,
        device=args.device,
    )


def degraded_baseline(config) -> dict:
    """PSNR/SSIM of the raw degraded inputs vs GT (the no-op enhancer)."""
    from ..data import BatchLoader, make_dataset
    from ..metrics import psnr, ssim_index

    sums, n = {"psnr": 0.0, "ssim": 0.0}, 0
    for domain in ("underwater", "atmospheric"):
        ds = make_dataset(f"synthetic-{domain}", task="val",
                          image_size=config.img_size,
                          synthetic_length=config.synthetic_length)
        for b in BatchLoader(ds, config.batch_size, shuffle=False):
            for i in range(b["input"].shape[0]):
                sums["psnr"] += psnr(b["gt"][i], b["input"][i])
                sums["ssim"] += ssim_index(b["gt"][i], b["input"][i])
                n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}


def _loss(v):
    """A stage's last loss rounded; None for a stage that ran no step."""
    return round(float(v), 4) if v is not None else None


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--channel", type=int, default=64)
    p.add_argument("--channel_mult", type=int, nargs="+", default=[1, 2])
    p.add_argument("--num_res_blocks", type=int, default=1)
    p.add_argument("--synthetic_length", type=int, default=0,
                   help="paired images per domain (default: batch*8)")
    p.add_argument("--domain_routing", action=argparse.BooleanOptionalAction,
                   default=False)
    p.add_argument("--T", type=int, default=200)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--save_every", type=int, default=10_000,
                   help="checkpoint cadence in epochs (for long runs)")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--color_weight", type=float, default=0.0)
    p.add_argument("--dino_weight", type=float, default=0.0)
    p.add_argument("--ms_ssim_weight", type=float, default=0.0)
    p.add_argument("--staged", action="store_true",
                   help="the reference's two stages (atmospheric, then "
                        "underwater, a fresh optimizer each) instead of "
                        "joint training; --steps splits evenly")
    p.add_argument("--stage1_losses", default="",
                   help='per-stage loss overrides, e.g. '
                        '"vgg=1.0,charbonnier=1.0" (run-book stage 1)')
    p.add_argument("--stage2_losses", default="",
                   help='e.g. "charbonnier=1.0,color=1.0,ms_ssim=0.0045"')
    p.add_argument("--aux_snr_weight", action="store_true",
                   help="scale x0-based aux losses by alpha_bar_t "
                        "(required for stability at large T)")
    p.add_argument("--eval_every", type=int, default=0,
                   help="val-PSNR probe cadence in epochs (0 = off)")
    p.add_argument("--eval_probe_steps", type=int, default=15)
    p.add_argument("--export_npz", default="",
                   help="also export weights npz here at every checkpoint")
    p.add_argument("--resume_from", default=None,
                   help='checkpoint to resume full state from ("auto" = '
                        "newest under --keep/ckpt)")
    p.add_argument("--init_from_npz", default="",
                   help="warm-start model weights from a flat params npz; "
                        "fresh optimizer (ignored with --resume_from)")
    p.add_argument("--device_data", action="store_true",
                   help="keep the train corpus on the card and gather "
                        "batches there")
    p.add_argument("--use_conditioning", action="store_true",
                   help="train with the live cemb image-conditioning path "
                        "and per-example CFG dropout (--p_uncond)")
    p.add_argument("--p_uncond", type=float, default=0.1,
                   help="per-example probability of zeroing cemb during "
                        "conditioned training (CFG dropout)")
    p.add_argument("--guidance", type=float, default=1.0,
                   help="guidance scale used by the post-train eval")
    p.add_argument("--skip_floor", action="store_true",
                   help="skip the untrained-floor eval (already recorded)")
    p.add_argument("--out", default=None, help="write JSON summary here")
    p.add_argument("--keep", default=None,
                   help="keep artifacts under this dir instead of a tempdir")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default) or "cpu"')
    args = p.parse_args()

    from ..config import Config
    from ..train.loop import evaluate, train

    tmp = args.keep or tempfile.mkdtemp(prefix="hdt_demo_")
    config = build_config(tmp, args)
    summary: dict = {"config": {
        "steps": args.steps, "size": args.size, "batch": args.batch,
        "channel": args.channel, "T": args.T, "ddim_steps": args.ddim_steps,
    }}

    # Untrained-floor eval: sample with random-init weights.
    if not args.skip_floor:
        t0 = time.time()
        eval_cfg = Config(**{**config.__dict__, "state": "eval",
                             "resume_from": None})
        floor = evaluate(eval_cfg, split="val", compute_fid=False,
                         save_images=False)
        summary["untrained"] = {
            d: {k: round(v, 3) for k, v in r.items() if k in ("psnr", "ssim")}
            for d, r in floor.items()}
        print(f"# untrained floor eval {time.time()-t0:.0f}s", file=sys.stderr)

    t0 = time.time()
    result = train(config, max_steps=args.steps)
    final_ckpt = result["stages"][-1]["checkpoint"]
    summary["train"] = {
        "steps": result["steps"],
        "last_loss": _loss(result["stages"][-1]["last_loss"]),
        "wall_s": round(time.time() - t0, 1),
        "checkpoint": final_ckpt,
        "stages": [
            {"stage": s["stage"], "last_loss": _loss(s["last_loss"]),
             "checkpoint": s["checkpoint"]}
            for s in result["stages"]],
    }

    # Eval the trained checkpoint (restore_params picks the subtree the
    # checkpoint's own probe/maturity evidence says samples best).
    t0 = time.time()
    eval_cfg = Config(**{**config.__dict__, "state": "eval",
                         "pretrained_path": final_ckpt})
    trained = evaluate(eval_cfg, split="val", compute_fid=False,
                       save_images=True)
    summary["trained"] = {
        d: {k: round(v, 3) for k, v in r.items()
            if k in ("psnr", "ssim", "uiqm", "uciqe", "n_images")}
        for d, r in trained.items()}
    summary["eval_wall_s"] = round(time.time() - t0, 1)
    summary["degraded_input_baseline"] = {
        k: round(v, 3) for k, v in degraded_baseline(config).items()}

    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    # The demo passes if training beat the untrained floor by a wide margin.
    if "untrained" not in summary:  # --skip_floor resume run
        return 0
    gain = min(
        summary["trained"][d]["psnr"] - summary["untrained"][d]["psnr"]
        for d in summary["trained"])
    print(f"# PSNR gain over untrained floor: {gain:+.2f} dB",
          file=sys.stderr)
    return 0 if gain > 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
