"""Where one flagship training step spends its device time.

    python -m hybrid_diffusion_tpu_torch.profile_train [--steps N]

Builds the train phase of chip_smoke.py on the card: the flagship model
(256², ch 128, mult (1,2,2,2), 2 res blocks, bf16) warm-started from the r5
npz, batch 16, the default composite loss with the DINO term (random-init
ViT-S at 252²), dropout 0.15, domain routing, EMA 0.99875, lr 1e-5; numpy
batches alternating blue- and red-heavy. Times N warm steps with the host
clock (each ends in a synchronize), then traces one more with
torch.profiler and prints: the device time by kernel class, the device's
busy and idle share of the traced step, the time of each of the step's
ranges (train/forward, train/loss, train/backward, train/update: the
optimizer, the gates and their blend, the EMA), the attention kernel's
forward and its recomputed backward, and, traced alone at the step's
shapes, the DINO term's forward + backward. Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import time

import numpy as np
import torch

from .config import flagship_config
from .diffusion import linear_beta_schedule
from .ops import attention as att
from .profile_serve import FLAGSHIP_NPZ, kernel_class
from .train.loop import create_train_state, init_params, make_dino
from .train.step import make_train_step
from .utils.cuda_build import nvidia_smi_line

BATCH = 16
# The r5 flagship's fine-tune settings: its sidecar's EMA decay
# (flagship256_r5_fp16.npz.json) and docs/RUNBOOK.md's lr for a warm start.
FINE_TUNE = dict(dropout=0.15, ema_decay=0.99875, lr=1e-5, batch_size=BATCH,
                 init_from_npz=str(FLAGSHIP_NPZ))
RANGES = ("train/forward", "train/loss", "train/backward", "train/update")
ATTENTION_BACKWARD = "RecomputedBackwardAttentionBackward"


def train_kernel_class(name: str) -> str:
    """profile_serve's classes, with the backward's convolution kernels and
    the optimizer's multi-tensor kernels named."""
    n = name.lower()
    if "wgrad" in n or "dgrad" in n:
        return "convolution"
    if "multi_tensor" in n or "foreach" in n:
        return "optimizer (multi-tensor)"
    return kernel_class(name)


def synthetic_batches(n: int, batch: int = BATCH, size: int = 256,
                      seed: int = 2) -> list[dict[str, np.ndarray]]:
    """n uint8 {input, gt} batches from numpy: the input blue-heavy
    (underwater) on even indices and red-heavy on odd ones, so that both
    gate patterns run."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        img = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
        gt = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
        c = 2 if i % 2 == 0 else 0
        img[..., c] = np.maximum(img[..., c], 200)
        out.append({"input": img, "gt": gt})
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=4,
                        help="warm steps timed with the host clock")
    args = parser.parse_args()
    smi = nvidia_smi_line()
    cfg = flagship_config(**FINE_TUNE)
    model = init_params(cfg, "cuda")
    state = create_train_state(cfg, model, steps_per_epoch=100)
    dino = make_dino(cfg, "cuda")
    step = make_train_step(linear_beta_schedule(cfg.beta_1, cfg.beta_T, cfg.T),
                           cfg.loss_config, dino_loss_fn=dino,
                           domain_routing=cfg.domain_routing)
    gen = torch.Generator("cuda").manual_seed(0)
    data = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
            for b in synthetic_batches(args.steps + 2)]

    step(state, data[0], gen)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for batch in data[1:-1]:
        t0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    att.reset_launch_count()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(state, data[-1], gen)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0

    by_kernel = collections.Counter()
    counts = collections.Counter()
    ranges = collections.Counter()      # device time of the kernels launched
    spans = collections.Counter()       # device-side span of each range
    for ev in prof.key_averages():
        on_card = ev.device_type == torch.autograd.DeviceType.CUDA
        if ev.key in RANGES:
            if on_card:        # the range's annotation on the card's timeline
                spans[ev.key] = ev.self_device_time_total
            else:
                ranges[ev.key] = ev.device_time_total
        elif ATTENTION_BACKWARD in ev.key and not on_card:
            ranges[ATTENTION_BACKWARD] = max(ranges[ATTENTION_BACKWARD],
                                             ev.device_time_total)
        elif on_card and ev.self_device_time_total > 0:   # kernels only
            by_kernel[ev.key] += ev.self_device_time_total
            counts[ev.key] += ev.count
    total_us = sum(by_kernel.values())
    if total_us == 0:
        raise SystemExit("the profiler recorded no kernel time on the card")
    by_class = collections.Counter()
    for name, us in by_kernel.items():
        by_class[train_kernel_class(name)] += us
    attention_fwd_us = by_class.get("attention (CUDA kernel)", 0.0)

    # The DINO term alone at the step's shapes: forward + backward wrt the
    # prediction, bf16 ViT-S at 252², batch 16; its kernels' device time in
    # one traced call (utils/timing.device_ms cannot queue it ahead of the
    # card: the host never gets far enough ahead).
    x0 = torch.rand(BATCH, 256, 256, 3, device="cuda") * 2 - 1
    gt = torch.rand(BATCH, 256, 256, 3, device="cuda") * 2 - 1
    x0.requires_grad_()
    for _ in range(2):
        torch.autograd.grad(dino(x0, gt), x0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as dprof:
        torch.autograd.grad(dino(x0, gt), x0)
        torch.cuda.synchronize()
    dino_ms = sum(ev.self_device_time_total for ev in dprof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3

    busy = total_us / 1e3 / (traced_wall * 1e3)
    print(f"card: {smi}; flagship train step, batch {BATCH}, bf16")
    print(f"untraced step: median {statistics.median(walls) * 1e3:.2f} ms over "
          f"{len(walls)} ({BATCH / statistics.median(walls):.2f} img/s); "
          f"peak memory {peak_gib:.2f} GiB")
    print(f"traced step: {traced_wall * 1e3:.2f} ms wall, {total_us / 1e3:.2f} "
          f"ms of kernels (busy {100 * busy:.1f}%, idle "
          f"{100 * (1 - busy):.1f}%), attention launches {att.launch_count}")
    for cls, us in by_class.most_common():
        print(f"  {cls:28s} {us / 1e3:9.3f} ms  {100 * us / total_us:5.1f}%")
    print("ranges: device time of the kernels each launched from the main "
          "thread (the backward's run on autograd's thread), and the span "
          "on the card's timeline:")
    for name in (*RANGES, ATTENTION_BACKWARD):
        print(f"  {name:40s} {ranges[name] / 1e3:9.3f} ms  span "
              f"{spans[name] / 1e3:9.3f} ms")
    print(f"attention forward kernel {attention_fwd_us / 1e3:.3f} ms, its "
          f"recomputed backward {ranges[ATTENTION_BACKWARD] / 1e3:.3f} ms "
          f"({100 * ranges[ATTENTION_BACKWARD] / total_us:.2f}% of the step)")
    print(f"DINO term alone, forward + backward: {dino_ms:.3f} ms of kernels")
    print("top kernels:")
    for name, us in by_kernel.most_common(15):
        print(f"  {us / 1e3:9.3f} ms  x{counts[name]:<5d} {name[:110]}")
    print(json.dumps({
        "card": smi, "batch": BATCH, "dtype": "bf16",
        "step_ms_median": statistics.median(walls) * 1e3,
        "step_ms": [w * 1e3 for w in walls],
        "peak_gib": peak_gib,
        "traced_step_ms": traced_wall * 1e3,
        "kernel_ms": total_us / 1e3,
        "idle_share": 1 - busy,
        "by_class_ms": {k: v / 1e3 for k, v in by_class.items()},
        "ranges_ms": {k: ranges[k] / 1e3 for k in (*RANGES, ATTENTION_BACKWARD)},
        "spans_ms": {k: spans[k] / 1e3 for k in RANGES},
        "attention_fwd_ms": attention_fwd_us / 1e3,
        "dino_fwd_bwd_ms": dino_ms,
        "attention_launches": att.launch_count}))


if __name__ == "__main__":
    main()
