#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

From a clean checkout, with no arguments, it:

  1. env    prints the Python, torch and CUDA versions and the card's name
            and power limit (nvidia-smi), and turns TF32 off for matmuls and
            cuDNN, so that every fp32 number below is full fp32;
  2. build  compiles the CUDA attention kernel with nvcc (or reuses the
            library built from the same source) and loads it;
  3. kernel holds the kernel against its plain PyTorch version on the card
            at the flagship shape and at bf16 / fp32 / fp16, d = 16 / 64 and
            a ragged N (in bf16 and fp32), and times kernel, plain version and
            scaled_dot_product_attention (CUDA events, median of 25);
  4. serve  loads docs/assets/flagship256_r5_fp16.npz into an Enhancer (256²,
            max_batch 8, bf16, DPM++2M-5) and answers 3 requests of 8, 8
            and 3 images, checking outputs and that the kernel ran 20 times
            per device call;
  5. path   runs the same weights at 64², batch 2, fp32, on one numpy
            initial noise through DPM++2M-5 on the card (kernel) and on the
            CPU (plain version), and requires PSNR ≥ 40 dB between them.

Every phase prints one line with its seconds. The whole run must finish
within BUDGET_S; a phase that fails or ends past the budget stops the run
with a non-zero exit. The last lines are the kernels' JSON record, the
card's nvidia-smi line and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "hybrid_diffusion_tpu_torch"
FLAGSHIP_NPZ = ROOT / "docs" / "assets" / "flagship256_r5_fp16.npz"
BUDGET_S = 300.0
T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def phase_done(name: str, t0: float, detail: str = "") -> None:
    now = time.perf_counter()
    total = now - T_START
    print(f"[{name}] {now - t0:.2f}s (total {total:.2f}s) {detail}", flush=True)
    if total > BUDGET_S:
        fail(f"time budget of {BUDGET_S:.0f}s exceeded after phase {name!r} "
             f"({total:.1f}s)", 3)


def time_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over `reps` of the mean device time of `inner` back-to-back
    calls, from CUDA events; warm (3 calls first)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def phase_kernel(att, torch):
    """Kernel vs its plain version on the card; returns the flagship row."""
    import torch.nn.functional as F

    # bf16/fp16 outputs are rounded once to their type (atol ~ half an ulp
    # at |out| < 1 plus the inputs' rounding); fp32 differs from the plain
    # version only in summation order. The ragged N = 1000 leaves 24 padded
    # keys in the last tile: unmasked, they would dilute the softmax by ~1.5%
    # (errors ~4e-3), far past the fp32 tolerance.
    cases = [  # (B, N, h, d, dtype, atol)
        (8, 1024, 8, 32, torch.bfloat16, 2e-2),   # the flagship's middle blocks
        (8, 1024, 8, 32, torch.float32, 1e-5),
        (8, 1024, 8, 16, torch.bfloat16, 2e-2),
        (8, 1000, 8, 32, torch.bfloat16, 2e-2),   # ragged N
        (8, 1000, 8, 32, torch.float32, 1e-5),    # ragged N, fp32
        (2, 1000, 8, 64, torch.float32, 1e-5),    # ragged N, d 64, fp32
        (2, 1024, 8, 64, torch.float16, 5e-3),
        (2, 256, 8, 16, torch.float16, 5e-3),
    ]
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    for B, N, h, d, dtype, atol in cases:
        # Strided views of one packed projection, as the model hands them over.
        qkv = torch.randn(B, N, 3, h, d, device="cuda", generator=gen,
                          dtype=torch.float32).to(dtype)
        q, k, v = qkv.unbind(2)
        before = att.launch_count
        out = att.fused_spatial_attention(q, k, v)
        torch.cuda.synchronize()
        if att.launch_count != before + 1 or out.dtype != dtype:
            fail(f"one call gave {att.launch_count - before} kernel launches "
                 f"and a {out.dtype} output for {dtype} inputs")
        ref = att.attention_reference(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        if not math.isfinite(err) or err > atol:
            fail(f"attention kernel disagrees with its plain version at "
                 f"B={B} N={N} h={h} d={d} {dtype}: max_abs_err {err} > {atol}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kernel_ms = time_ms(lambda: att.fused_spatial_attention(q, k, v))
        plain_ms = time_ms(lambda: att.attention_reference(q, k, v), reps=5,
                           inner=2)
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt))
        esize = q.element_size()
        flops = 4.0 * B * h * N * N * d
        nbytes = 4.0 * B * N * h * d * esize
        t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
        t_bytes = nbytes / HBM_BYTES_PER_S
        row = dict(B=B, N=N, h=h, d=d, dtype=str(dtype).split(".")[-1],
                   max_abs_err=err, tol=atol, kernel_ms=kernel_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_us=max(t_ops, t_bytes) * 1e6,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        print("  kernel " + json.dumps(row), flush=True)
        rows.append(row)
    return rows[0]


def psnr(a, b) -> float:
    mse = float(((a - b) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * math.log10(1.0 / mse)


def main() -> None:
    # ---------------------------------------------------------------- env
    t0 = time.perf_counter()
    if not (PACKAGE / "csrc" / "attention.cu").is_file():
        fail(f"the port's sources are not beside this script ({PACKAGE})", 2)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU", 2)
    sys.path.insert(0, str(ROOT))
    from hybrid_diffusion_tpu_torch.config import flagship_config
    from hybrid_diffusion_tpu_torch.ops import attention as att
    from hybrid_diffusion_tpu_torch.serve import Enhancer
    from hybrid_diffusion_tpu_torch.train.loop import build_model, make_sampler
    from hybrid_diffusion_tpu_torch.utils.cuda_build import nvidia_smi_line
    from hybrid_diffusion_tpu_torch.weights import load_npz_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    phase_done("env", t0, f"python {sys.version.split()[0]} torch "
               f"{torch.__version__} cuda {torch.version.cuda} | {smi} | "
               f"TF32 off for matmul and cuDNN")

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    built = att.load_kernel()
    ptxas = [ln.strip() for ln in built.ptxas_log.splitlines()
             if "registers" in ln or "spill" in ln]
    phase_done("build", t0, f"nvcc {built.build_seconds:.2f}s "
               f"cached={built.cached} {built.path.name}")
    for ln in ptxas:
        print("  ptxas " + ln, flush=True)

    # ---------------------------------------------------------------- kernel
    t0 = time.perf_counter()
    flagship_row = phase_kernel(att, torch)
    phase_done("kernel", t0, "all shapes within tolerance")

    # ---------------------------------------------------------------- serve
    t0 = time.perf_counter()
    cfg = flagship_config()
    att.reset_launch_count()
    enh = Enhancer(cfg, FLAGSHIP_NPZ, max_batch=8, device="cuda")
    if att.launch_count != 20 * enh.device_calls:
        fail(f"warm-up launched the attention kernel {att.launch_count} "
             f"times in {enh.device_calls} device call(s), expected 20 each")
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, 256, (n, 256, 256, 3), dtype=np.uint8)
                for n in (8, 8, 3)]
    att.reset_launch_count()
    calls_before = enh.device_calls
    latencies = []
    torch.cuda.reset_peak_memory_stats()
    for batch in requests:
        t_req = time.perf_counter()
        outs = enh.enhance(list(batch))
        latencies.append(time.perf_counter() - t_req)
        if len(outs) != len(batch):
            fail(f"{len(batch)} images in, {len(outs)} out")
        for o in outs:
            if o.shape != (256, 256, 3) or o.dtype != np.uint8:
                fail(f"output {o.shape} {o.dtype}, expected (256, 256, 3) uint8")
        if int(np.ptp(np.stack(outs))) == 0:
            fail("every output value is the same")
    launches = att.launch_count
    calls = enh.device_calls - calls_before
    if launches != 20 * calls:
        fail(f"the attention kernel ran {launches} times in {calls} device "
             f"calls on the main path, expected 20 per call")
    n_img = sum(len(b) for b in requests)
    serve_s = sum(latencies)
    phase_done("serve", t0, (
        f"{n_img} images in {calls} calls, {serve_s:.3f}s, "
        f"{n_img / serve_s:.2f} img/s, call latencies "
        f"{[round(x * 1e3, 1) for x in latencies]} ms, attention launches "
        f"{launches} ({launches // calls} per call), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}"))
    del enh

    # ---------------------------------------------------------------- path
    t0 = time.perf_counter()
    cfg64 = flagship_config(img_size=64, bf16=False)
    state = load_npz_state_dict(FLAGSHIP_NPZ)
    rng = np.random.default_rng(1)
    cond = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    noise = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    outs = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg64)
        model.load_state_dict(state, strict=True)
        model = model.to(device).eval()
        before = att.launch_count
        out = make_sampler(cfg64, model)(
            torch.from_numpy(cond).to(device),
            init_noise=torch.from_numpy(noise).to(device))
        outs[device] = out.cpu().numpy().astype(np.float64)
        used = att.launch_count - before
        if used != (20 if device == "cuda" else 0):
            fail(f"the {device} run launched the kernel {used} times")
    gpu, cpu = outs["cuda"], outs["cpu"]
    if gpu.shape != (2, 64, 64, 3) or not np.isfinite(gpu).all():
        fail(f"card output {gpu.shape} is not a finite (2, 64, 64, 3) image")
    max_diff = float(np.abs(gpu - cpu).max())
    db = psnr(gpu, cpu)
    if db < 40.0:
        fail(f"card vs CPU PSNR {db:.2f} dB < 40 dB (max |diff| {max_diff})")
    phase_done("path", t0, f"64² batch 2 DPM++2M-5 fp32, card (kernel) vs CPU "
               f"(plain): max |diff| {max_diff:.3e}, PSNR {db:.2f} dB")

    row = flagship_row
    print(json.dumps({"kernels": [{
        "name": "attention_fwd",
        "route": "cuda",
        "source": "hybrid_diffusion_tpu_torch/csrc/attention.cu",
        "replaces": "hybrid_diffusion_tpu/ops/attention.py:63",
        "launches": launches,
        "max_abs_err": row["max_abs_err"],
        "ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_us"] / 1e3,
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
