"""The reference's staged two-stage training recipe, end to end on the card.

Counterpart of the JAX package's `scripts/demo_staged.py`: sequential
stages with fresh optimizers and the run-book's per-stage loss sets,

  stage 1  "Pre-Training (VGG+Charbonnier)"          — atmospheric domain
  stage 2  "Enhancement Training (Charbonnier +
            Angular Color Loss + MS-SSIM)"           — underwater domain

with the diffusion ε-MSE always on, at 128², T 200 and --aux_snr_weight,
through `train()`; then `evaluate()` of the stage-2 checkpoint on both
domains' val split and the degraded-input (no-op) baseline. VGG runs at
random init unless HDT_VGG_WEIGHTS names its weights. Writes a JSON summary
with the JAX script's keys; exits 0 when the trained PSNR beats the no-op
baseline by more than 0.5 dB on both domains, else 1.

    python -m hybrid_diffusion_tpu_torch.scripts.demo_staged \
        [--steps_per_stage 2000] [--out FILE] [--keep DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

STAGE1_LOSSES = "mse=1,vgg=1,charbonnier=1,dino=0,ms_ssim=0,color=0"
STAGE2_LOSSES = "mse=1,charbonnier=1,color=1,ms_ssim=0.0045,dino=0,vgg=0"


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps_per_stage", type=int, default=2000)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--channel", type=int, default=64)
    p.add_argument("--channel_mult", type=int, nargs="+", default=[1, 2, 2])
    p.add_argument("--num_res_blocks", type=int, default=1)
    p.add_argument("--T", type=int, default=200)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--synthetic_length", type=int, default=256)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--eval_every", type=int, default=0,
                   help="val-PSNR probe cadence in epochs; probes both "
                        "domains every time, so stage-2 forgetting of the "
                        "stage-1 domain shows as it happens")
    p.add_argument("--stage2_replay", type=float, default=0.0,
                   help="fraction of stage-2 steps trained on the stage-1 "
                        "domain (replacement, budget unchanged)")
    p.add_argument("--out", default=None)
    p.add_argument("--keep", default=None)
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default) or "cpu"')
    args = p.parse_args()

    from ..config import Config
    from ..train.loop import evaluate, train
    from .demo_e2e import degraded_baseline

    tmp = args.keep or tempfile.mkdtemp(prefix="hdt_staged_")
    steps_per_epoch = max(args.synthetic_length // args.batch, 1)
    stage_epochs = max(args.steps_per_stage // steps_per_epoch, 1)
    config = Config(
        state="train",
        synthetic_data=True,
        synthetic_length=args.synthetic_length,
        img_size=args.size,
        batch_size=args.batch,
        channel=args.channel,
        channel_mult=args.channel_mult,
        num_res_blocks=args.num_res_blocks,
        T=args.T,
        dropout=0.1,
        lr=args.lr,
        joint_training=False,          # the staged path
        epochs_stage_1=stage_epochs,   # atmospheric pre-training
        epochs_stage_2=stage_epochs,   # underwater enhancement
        stage1_losses=STAGE1_LOSSES,
        stage2_losses=STAGE2_LOSSES,
        aux_snr_weight=True,
        domain_routing=False,
        ema_decay=min(0.999, 1.0 - 20.0 / max(args.steps_per_stage, 40)),
        ddim=True,
        ddim_step=args.ddim_steps,
        save_checkpoint=10_000,
        log_every=50,
        eval_every=args.eval_every,
        stage2_replay=args.stage2_replay,
        checkpoint_dir=os.path.join(tmp, "ckpt"),
        output_path=os.path.join(tmp, "out"),
        # No effect in the port; set as the JAX script sets it.
        compilation_cache=os.environ.get("JAX_COMPILATION_CACHE_DIR",
                                         ".jax_cache"),
        device=args.device,
    )

    t0 = time.time()
    result = train(config, max_steps=2 * args.steps_per_stage)
    train_wall = time.time() - t0
    summary: dict = {
        "recipe": {"stage1": STAGE1_LOSSES, "stage2": STAGE2_LOSSES,
                   "steps_per_stage": args.steps_per_stage,
                   "size": args.size, "channel": args.channel, "T": args.T,
                   "aux_snr_weight": True,
                   "stage2_replay": args.stage2_replay},
        "stages": [
            {"stage": s["stage"],
             "last_loss": (round(float(s["last_loss"]), 4)
                           if s["last_loss"] is not None else None),
             "checkpoint": s["checkpoint"]}
            for s in result["stages"]],
        "train": {"steps": result["steps"],
                  "wall_s": round(train_wall, 1)},
    }

    # Score the stage-2 final checkpoint on the val split of both domains.
    t0 = time.time()
    eval_cfg = Config(**{**config.__dict__, "state": "eval",
                         "pretrained_path": result["stages"][-1]["checkpoint"]})
    trained = evaluate(eval_cfg, split="val", compute_fid=False,
                       save_images=True)
    summary["trained"] = {
        d: {k: round(float(v), 3) for k, v in r.items()
            if k in ("psnr", "ssim", "uiqm", "uciqe", "n_images")}
        for d, r in trained.items()}
    summary["eval_wall_s"] = round(time.time() - t0, 1)
    # No-op enhancer baseline: the degraded inputs themselves.
    summary["degraded_input_baseline"] = {
        k: round(v, 3) for k, v in degraded_baseline(config).items()}

    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    gain = min(summary["trained"][d]["psnr"]
               for d in summary["trained"]) - summary[
                   "degraded_input_baseline"]["psnr"]
    print(f"# staged-recipe PSNR vs no-op baseline: {gain:+.2f} dB",
          file=sys.stderr)
    return 0 if gain > 0.5 else 1


if __name__ == "__main__":
    sys.exit(main())
