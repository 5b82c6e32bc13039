"""Where one flagship serving call spends its device time.

    python -m hybrid_diffusion_tpu_torch.profile_serve [--fp32 [--keep-tf32]]

Builds the flagship Enhancer (256², bf16, DPM++2M-5, the r5 flagship npz,
batch 8) on the card, or with --fp32 its full-precision mode (bf16=False,
with the caller's TF32 flags turned off for matmuls and cuDNN as in
chip_smoke.py; with --keep-tf32 the caller's flags stay at PyTorch's
defaults, cuDNN's TF32 on: what a process that sets nothing gets. The
Enhancer's fp32 calls turn TF32 off themselves (utils/precision.py), so
both give fp32 convolutions; before that repair --keep-tf32 ran them on
TF32), times CALLS warm device calls with the host clock
(each ends in a copy to the host), then traces one more call with
torch.profiler and prints the device time by kernel class (attention
kernel, convolutions, matrix products, GroupNorm, copies and casts, other
elementwise), the top kernels, the device's busy share of the traced
call (the union of its kernels' and copies' intervals over the call's wall
time), and the call's spans (utils/profiling.py::span: `enhance` and its
resizes, copies and sampler call, each sampler step), each with its host
ms, its device ms where it has one, and its attrs. Prints one JSON line
last.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from .config import flagship_config
from .ops import attention as att
from .serve import Enhancer
from .utils.cuda_build import nvidia_smi_line
from .utils.profiling import busy_us, clear, spans

FLAGSHIP_NPZ = (Path(__file__).resolve().parent.parent / "docs" / "assets"
                / "flagship256_r5_fp16.npz")
BATCH = 8
CALLS = 5


def kernel_class(name: str) -> str:
    n = name.lower()
    if "attention_fwd" in n:  # attention_fwd_{mma,tf32}_kernel
        return "attention (CUDA kernel)"
    if any(k in n for k in ("conv", "implicit_gemm", "xmma_fprop", "fprop",
                            "winograd", "nchwtonhwc", "nhwctonchw")):
        return "convolution"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "matmul")):
        return "matrix product"
    if any(k in n for k in ("groupnorm", "group_norm", "rowwisemoments",
                            "computefusedparams")):
        return "groupnorm"
    if "copy" in n:
        return "copy / dtype cast"
    return "elementwise"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fp32", action="store_true",
                        help="serve in fp32 (bf16=False), TF32 off")
    parser.add_argument("--keep-tf32", action="store_true",
                        help="with --fp32: leave the caller's TF32 flags at "
                             "PyTorch's defaults")
    args = parser.parse_args()
    fp32 = args.fp32
    if fp32 and not args.keep_tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tf32 = (f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
            f"cuDNN {torch.backends.cudnn.allow_tf32}")
    smi = nvidia_smi_line()
    enh = Enhancer(flagship_config(bf16=not fp32), FLAGSHIP_NPZ,
                   max_batch=BATCH)
    rng = np.random.default_rng(0)
    batch = list(rng.integers(0, 256, (BATCH, 256, 256, 3), dtype=np.uint8))

    walls = []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        enh.enhance(batch)
        walls.append(time.perf_counter() - t0)

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    att.reset_launch_count()
    clear()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        enh.enhance(batch)
        traced_wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    traced_spans = [{"name": r["name"],
                     "host_ms": (r["end_ns"] - r["start_ns"]) / 1e6,
                     "device_ms": r["device_ms"], "attrs": r["attrs"]}
                    for r in spans()]

    by_kernel = collections.Counter()
    counts = collections.Counter()
    for ev in prof.key_averages():
        # Kernels only: an operator's entry repeats its kernels' time, and
        # a span's range on the card's timeline covers its kernels.
        us = ev.self_device_time_total
        if (ev.device_type == torch.autograd.DeviceType.CUDA and us > 0
                and not ev.is_user_annotation):
            by_kernel[ev.key] += us
            counts[ev.key] += ev.count
    total_us = sum(by_kernel.values())
    if total_us == 0:
        raise SystemExit("the profiler recorded no kernel time on the card")
    by_class = collections.Counter()
    for name, us in by_kernel.items():
        by_class[kernel_class(name)] += us

    print(f"card: {smi}; {'fp32' if fp32 else 'bf16'}; {tf32}")
    print(f"untraced call: median {statistics.median(walls) * 1e3:.2f} ms "
          f"over {CALLS} (batch {BATCH}, "
          f"{BATCH / statistics.median(walls):.2f} img/s)")
    busy = busy_us(prof) / 1e6 / traced_wall
    print(f"traced call: {traced_wall * 1e3:.2f} ms wall, "
          f"{total_us / 1e3:.2f} ms of kernels (busy {100 * busy:.1f}%), "
          f"attention launches {att.launch_count}")
    for cls, us in by_class.most_common():
        print(f"  {cls:28s} {us / 1e3:9.3f} ms  {100 * us / total_us:5.1f}%")
    print("top kernels:")
    for name, us in by_kernel.most_common(12):
        print(f"  {us / 1e3:9.3f} ms  x{counts[name]:<5d} {name[:110]}")
    print("spans of the traced call: host ms, device ms, attrs")
    for sp in traced_spans:
        device = "" if sp["device_ms"] is None else f"{sp['device_ms']:9.3f}"
        print(f"  {sp['name']:20s} {sp['host_ms']:9.3f} {device:>9s}  "
              f"{sp['attrs'] or ''}")
    print(json.dumps({
        "card": smi, "batch": BATCH, "dtype": "fp32" if fp32 else "bf16",
        "tf32": tf32,
        "call_ms_median": statistics.median(walls) * 1e3,
        "call_ms": [w * 1e3 for w in walls],
        "traced_call_ms": traced_wall * 1e3,
        "kernel_ms": total_us / 1e3,
        "busy_share": busy,
        "by_class_ms": {k: v / 1e3 for k, v in by_class.items()},
        "spans": traced_spans,
        "attention_launches": att.launch_count}))


if __name__ == "__main__":
    main()
