#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

From a clean checkout, with no arguments, it:

  1. env    prints the Python, torch and CUDA versions and the card's name
            and power limit (nvidia-smi), and turns TF32 off for matmuls and
            cuDNN, so that every fp32 number below is full fp32;
  2. build  compiles the CUDA attention kernels with nvcc (or reuses the
            library built from the same source) and loads them; prints each
            of the 11 kernel instances' (bf16, fp16 at d 16, 32, 64; fp32
            at d 16 and 32 with one and two m16 tiles a warp, and at d 64)
            registers and spills (ptxas) and its count of HMMA
            (tensor-core) instructions (cuobjdump -sass), and fails if one
            has none or spills;
  3. kernel holds the kernels against their plain PyTorch version on the
            card at the shapes the serve and path phases give them, at
            bf16 / fp16 / fp32, d = 16 / 64, a ragged N and inputs that
            catch a missing mask, and times kernel, plain version and
            scaled_dot_product_attention (CUDA events, median of 25, with
            the calls queued ahead of the card), and the wrapper's host time
            per call;
  4. serve  loads docs/assets/flagship256_r5_fp16.npz into an Enhancer (256²,
            max_batch 8, bf16, DPM++2M-5) and answers 3 requests of 8, 8
            and 3 images, checking outputs and that the bf16 kernel ran 20
            times per device call; then answers one request of 8 from an
            fp32 Enhancer (bf16=False), which must launch the fp32 kernel
            20 times;
  5. path   runs the same weights at 64², batch 2, on one numpy initial
            noise through DPM++2M-5 on the card in fp32 (the fp32 kernel)
            and in bf16 (the bf16 kernel), 20 launches each, and on the CPU
            in fp32 (plain version), and requires PSNR ≥ 40 dB (fp32) and
            ≥ 38 dB (bf16) against the CPU;
  6. train  takes TRAIN_STEPS training steps at the flagship width (256²,
            batch 16, bf16, the default composite loss with the DINO term
            on a random-init ViT-S at 252², dropout 0.15, domain routing,
            EMA 0.99875, lr 1e-5, warm-started from the r5 npz) on numpy
            batches that alternate blue- and red-heavy; each step must give
            finite losses, launch the bf16 kernel 4 times and no other
            kernel, and leave the gated-off middle blocks' parameters and
            AdamW moments bit for bit as they were while the open ones move;
            prints the median step time after the first, the peak memory
            and the card's nvidia-smi line;
  7. tparity one fp32 step (TF32 off) at 64², batch 2, from the npz, dropout
            0, fixed t and noise, on the card and on the CPU: the losses
            within TRAIN_LOSS_RTOL and the gradients' difference within
            max(TRAIN_GRAD_FLOOR, 10 κ) of their norm, κ being the CPU
            step's own change when every weight moves by one ulp; prints
            the same step on the card with TF32 on beside that bound.

The kernel phase also holds the attention's forward and gradients (the
kernel's forward inside the autograd Function, the backward recomputed
through the plain version) against the plain version's at the training
shape (16, 1024, 8, 32) in bf16 and at (2, 64, 8, 32) in fp32, on strided
views of one packed projection, and times forward + backward against
scaled_dot_product_attention's.

Every phase prints one line with its seconds. The whole run must finish
within BUDGET_S; a phase that fails or ends past the budget stops the run
with a non-zero exit. The last lines are the kernels' JSON record, the
card's nvidia-smi line and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "hybrid_diffusion_tpu_torch"
FLAGSHIP_NPZ = ROOT / "docs" / "assets" / "flagship256_r5_fp16.npz"
BUDGET_S = 300.0
T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, and FLOP/s of the
# products by input type. The bound counts the products the function needs,
# 4·B·h·N²·d, at the card's fastest rate for the type: fp32 products at the
# TF32 tensor cores' 495 TFLOP/s, not the FMA units' 67. The fp32 kernel's
# own design, three TF32 products a product (3xTF32), has a floor three
# times that, printed beside it (tf32x3_floor_ms) and not used as the bound:
# another split (for example fp16 parts with scaling) could need less.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12}
# The H100 SXM5's special-function (exp2) rate, 3.9 T/s: "989 TFLOPS of FP16
# matmul but only 3.9 TFLOPS of special functions" (Shah et al. 2024,
# FlashAttention-3, section 3.3). Attention computes B·h·N² exponentials.
EXP_PER_S = 3.9e12

# Kernel vs the fp32 plain version, max abs error, by dtype and inputs.
# bf16/fp16: the kernel rounds P to the input type before P·V and the output
# once. Its CPU emulation (tests/test_torch_attention_tiled.py) errs by at
# most 1.8e-3 (bf16) and 2.5e-4 (fp16) on random inputs at the shapes of
# KERNEL_CASES (|out| about 0.03 to 0.07 there), and by 4.1e-3 and 5.1e-4 on
# the mask-trap ones (|out| about 1). Each tolerance is that error times a
# margin of 4.4 to 5.0; it is not looser than the error calls for. An
# unmasked padded key (error ~1 on the mask trap) fails them. fp32: each
# product is three TF32 products (about 2^-21 relative); the CPU emulation
# (tests/test_torch_attention_tf32.py) errs by at most 8.1e-7 on the fp32
# cases, a twelfth of 1e-5, and a single TF32 product by 2.4e-4 to 6.6e-4.
ATOL = {("bfloat16", "randn"): 8e-3, ("bfloat16", "mask trap"): 2e-2,
        ("float16", "randn"): 1.25e-3, ("float16", "mask trap"): 2.5e-3,
        ("float32", "randn"): 1e-5}

# The attention shapes the main paths give the kernels: the serve phase's
# flagship (256², batch 8: N 32·32) in bf16 and in fp32 (bf16=False), the
# path phase's fp32 run (64², batch 2: N 8·8) and the train phase's flagship
# (256², batch 16) in bf16, all with 8 heads of d 32.
SERVE_CASE = (8, 1024, 8, 32, "bfloat16", "randn")
FP32_SERVE_CASE = (8, 1024, 8, 32, "float32", "randn")
PATH_CASE = (2, 64, 8, 32, "float32", "randn")
TRAIN_CASE = (16, 1024, 8, 32, "bfloat16", "randn")
# (B, N, h, d, dtype, inputs) of the kernel phase. The ragged N = 1000 leaves
# 24 padded keys in the last tile: unmasked, they would dilute the softmax
# by ~1.5% (errors ~4e-3), far past the fp32 tolerance; the mask-trap inputs
# make the same fault an error of ~1 in bf16 and fp16.
KERNEL_CASES = [
    SERVE_CASE,
    PATH_CASE,
    FP32_SERVE_CASE,
    TRAIN_CASE,
    (8, 1024, 8, 16, "bfloat16", "randn"),
    (8, 1024, 8, 64, "bfloat16", "randn"),
    (8, 1000, 8, 32, "bfloat16", "randn"),  # ragged N
    (8, 1000, 8, 32, "bfloat16", "mask trap"),
    (8, 1000, 8, 32, "float16", "mask trap"),
    (8, 1000, 8, 32, "float32", "randn"),   # ragged N, fp32
    (2, 1000, 8, 64, "float32", "randn"),   # ragged N, d 64, fp32
    (2, 256, 8, 16, "float32", "randn"),    # d 16, fp32
    (2, 1024, 8, 64, "float16", "randn"),
    (2, 256, 8, 16, "float16", "randn"),
]

# The attention's training shapes: the train phase's flagship (256², batch
# 16: N 32·32) in bf16, and the tparity phase's fp32 (64², batch 2: N 8·8).
# The Function's forward is the kernel's, held against the fp32 plain
# version at ATOL; its gradients against the plain version's autograd at the
# same dtype: its backward IS the plain version's, at the saved inputs, so
# they agree but for the order the card sums in (0 measured on the CPU).
TRAIN_GRAD_CASES = [TRAIN_CASE[:5], (2, 64, 8, 32, "float32")]
GRAD_RTOL = {"bfloat16": 2.0 ** -8, "float32": 1e-6}

# The train phase's steps (the first one warms up and is left out of the
# median); its settings are profile_train.py's FINE_TUNE: batch 16, the r5
# flagship's EMA decay and warm-start lr, dropout 0.15.
TRAIN_STEPS = 5
# The tparity phase's bounds. The loss: fp32 summed in another order (the
# CPU tests hold the port's loss to JAX's at 1e-5). The gradients: ten times
# κ, the change of the CPU step's gradients when every weight moves by one
# ulp, measured in the same run (1.05e-5 on the H100, the card's difference
# 1.51e-5), and never below TRAIN_GRAD_FLOOR.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_FLOOR = 1e-4

# The path phase's limits on PSNR against the CPU's fp32 sampler (64², batch
# 2, DPM++2M-5). fp32: the same arithmetic summed in another order (112.38 dB
# measured on the H100). bf16: the CPU port's bf16 sampler measured
# 42.99 dB against the JAX fp32 one on these inputs, and JAX's own bf16
# sampler 42.34 dB; 38 dB leaves about 5 dB for the card's other rounding
# (cuDNN's bf16 convolutions, the tensor-core attention).
PATH_PSNR_FP32_DB = 40.0
PATH_PSNR_BF16_DB = 38.0


def mask_trap_qkv(rng, B: int, N: int, h: int, d: int):
    """Packed (B, N, 3, h, d) float32 q|k|v whose every real score
    q·k/√d is about −30 (q ≈ 1, k ≈ −30/√d), with v ≈ 1. A zero-filled
    padded key that escaped the mask would score 0 and, with v 0, take
    nearly all the weight: an error of about 1."""
    import numpy as np

    noise = 0.1 * rng.standard_normal((B, N, 3, h, d))
    centre = np.array([1.0, -30.0 / math.sqrt(d), 1.0])[:, None, None]
    return (centre + noise).astype(np.float32)


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


def phase_build(att, cuda_build):
    """Build and load the library; check its kernels' resources and that
    every kernel runs on the tensor cores."""
    built = att.load_kernel()
    resources = cuda_build.kernel_resources(built.ptxas_log)
    try:
        cuobjdump = cuda_build.find_cuobjdump()
        hmma = cuda_build.sass_opcode_counts(built.path, "HMMA")
    except (RuntimeError, OSError) as e:
        fail(f"cannot count the kernels' tensor-core instructions: {e}")
    print(f"  nvcc {built.build_seconds:.2f}s cached={built.cached} "
          f"{built.path.name}; SASS read with {cuobjdump}", flush=True)
    tensor_core = 0
    for sym, res in sorted(resources.items()):
        inst = att.kernel_instance(sym)
        if inst is None:
            continue
        name, dtype, d = inst
        n_hmma = hmma.get(sym, 0)
        print(f"  {name}<{str(dtype).split('.')[-1]}, d {d}>: "
              f"{res.registers} registers, {res.spill_bytes} bytes spilled, "
              f"{n_hmma} HMMA", flush=True)
        tensor_core += 1
        if n_hmma == 0 or res.spill_bytes:
            fail(f"{name}<{dtype}, {d}> has {n_hmma} HMMA instructions "
                 f"and spills {res.spill_bytes} bytes")
    if tensor_core != 11:
        fail(f"found {tensor_core} tensor-core kernel instances in ptxas's "
             f"report, expected 11 (bf16, fp16 at d 16, 32, 64; fp32 twice "
             f"at d 16 and 32, once at d 64)")
    return built


def phase_kernel(att, torch, device_ms, host_ms):
    """Kernels vs their plain version on the card; returns the rows."""
    import numpy as np
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    rows = {}
    for case in KERNEL_CASES:
        B, N, h, d, dname, inputs = case
        dtype = getattr(torch, dname)
        atol = ATOL[dname, inputs]
        # Strided views of one packed projection, as the model hands them over.
        if inputs == "randn":
            qkv = torch.randn(B, N, 3, h, d, device="cuda", generator=gen,
                              dtype=torch.float32)
        else:
            qkv = torch.from_numpy(mask_trap_qkv(rng, B, N, h, d)).cuda()
        q, k, v = qkv.to(dtype).unbind(2)
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
                 f"B={B} N={N} h={h} d={d} {dtype} ({inputs}): max_abs_err "
                 f"{err} > {atol}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kernel_ms = device_ms(lambda: att.fused_spatial_attention(q, k, v))
        kernel_host_ms = host_ms(lambda: att.fused_spatial_attention(q, k, v))
        plain_ms = device_ms(lambda: att.attention_reference(q, k, v), reps=5,
                             inner=2)
        library_ms = device_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt))
        flops = 4.0 * B * h * N * N * d
        nbytes = 4.0 * B * N * h * d * q.element_size()
        t_ops = flops / PEAK_FLOPS[dname]
        t_bytes = nbytes / HBM_BYTES_PER_S
        row = dict(B=B, N=N, h=h, d=d, dtype=dname, inputs=inputs,
                   kernel=att.KERNEL_BY_DTYPE[dtype],
                   max_abs_err=err, tol=atol, kernel_ms=kernel_ms,
                   kernel_host_ms=kernel_host_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   exp_floor_ms=B * h * N * N / EXP_PER_S * 1e3)
        if dname == "float32":
            row["tf32x3_floor_ms"] = 3 * t_ops * 1e3
        print("  kernel " + json.dumps(row), flush=True)
        rows[case] = row
    return rows


def phase_grad(att, torch, device_ms):
    """The attention's gradients through the autograd Function against the
    plain version's autograd, and forward + backward timed against SDPA's,
    at the training shapes; returns rows by (B, N, h, d, dtype)."""
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(1)
    rows = {}
    for B, N, h, d, dname in TRAIN_GRAD_CASES:
        dtype = getattr(torch, dname)
        qkv = torch.randn(B, N, 3, h, d, device="cuda", generator=gen)
        qkv = qkv.to(dtype).requires_grad_()
        g = torch.randn(B, N, h, d, device="cuda", generator=gen).to(dtype)

        def kernel_fwd_bwd():
            out = att.fused_spatial_attention(*qkv.unbind(2))
            return out, torch.autograd.grad(out, qkv, g)[0]

        def plain_fwd_bwd(x=qkv, grad=g):
            out = att.attention_reference(*x.unbind(2))
            return out, torch.autograd.grad(out, x, grad)[0]

        def sdpa_fwd_bwd():
            q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
            out = F.scaled_dot_product_attention(q, k, v)
            return out, torch.autograd.grad(out, qkv, g.transpose(1, 2))[0]

        before = att.launch_count
        out, grad = kernel_fwd_bwd()
        torch.cuda.synchronize()
        if att.launch_count != before + 1:
            fail(f"forward + backward launched the kernel "
                 f"{att.launch_count - before} times, expected once")
        with torch.no_grad():
            fwd_ref = att.attention_reference(
                *qkv.detach().float().unbind(2))
        fwd_err = (out.detach().float() - fwd_ref).abs().max().item()
        fwd_tol = ATOL[dname, "randn"]
        if not math.isfinite(fwd_err) or fwd_err > fwd_tol:
            fail(f"the Function's forward (the kernel) disagrees with the "
                 f"fp32 plain version at B={B} N={N} h={h} d={d} {dtype}: "
                 f"max_abs_err {fwd_err} > {fwd_tol}")
        _, ref = plain_fwd_bwd()
        err = (grad.float() - ref.float()).abs().max().item()
        tol = GRAD_RTOL[dname] * ref.float().abs().max().item()
        if not math.isfinite(err) or err > tol:
            fail(f"attention gradients through the kernel disagree with the "
                 f"plain version's at B={B} N={N} h={h} d={d} {dtype}: "
                 f"max_abs_err {err} > {tol}")
        x32 = qkv.detach().float().requires_grad_()
        _, ref32 = plain_fwd_bwd(x32, g.float())
        err32 = (grad.float() - ref32).abs().max().item()
        flops = 12.0 * B * h * N * N * d    # forward 4, its vjp 8
        nbytes = 8.0 * B * N * h * d * qkv.element_size()
        t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / HBM_BYTES_PER_S
        row = dict(B=B, N=N, h=h, d=d, dtype=dname,
                   fwd_max_abs_err=fwd_err, fwd_tol=fwd_tol,
                   grad_max_abs_err=err, grad_tol=tol,
                   grad_max_abs_err_vs_fp32=err32,
                   fwd_bwd_ms=device_ms(kernel_fwd_bwd, reps=15, inner=5),
                   plain_fwd_bwd_ms=device_ms(plain_fwd_bwd, reps=5, inner=2),
                   sdpa_fwd_bwd_ms=device_ms(sdpa_fwd_bwd, reps=15, inner=5),
                   fwd_bwd_bound_ms=max(t_ops, t_bytes) * 1e3,
                   fwd_bwd_bound_by="operations" if t_ops >= t_bytes
                   else "bytes")
        print("  grad " + json.dumps(row), flush=True)
        rows[B, N, h, d, dname] = row
    return rows


def phase_train(att, torch, np, smi):
    """TRAIN_STEPS flagship-width bf16 steps; returns the phase's record."""
    from hybrid_diffusion_tpu_torch.config import flagship_config
    from hybrid_diffusion_tpu_torch.diffusion import linear_beta_schedule
    from hybrid_diffusion_tpu_torch.profile_train import (
        FINE_TUNE, synthetic_batches)
    from hybrid_diffusion_tpu_torch.train.loop import (
        create_train_state, init_params, make_dino)
    from hybrid_diffusion_tpu_torch.train.step import (
        make_train_step, middle_block)

    cfg = flagship_config(**FINE_TUNE)
    model = init_params(cfg, "cuda")
    state = create_train_state(cfg, model, steps_per_epoch=100)
    dino = make_dino(cfg, "cuda")
    step = make_train_step(
        linear_beta_schedule(cfg.beta_1, cfg.beta_T, cfg.T), cfg.loss_config,
        dino_loss_fn=dino, use_conditioning=cfg.use_conditioning,
        p_uncond=cfg.p_uncond, domain_routing=cfg.domain_routing)
    gen = torch.Generator("cuda").manual_seed(cfg.seed)
    # On the card before the timed loop, as profile_train stages them.
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b in synthetic_batches(TRAIN_STEPS, cfg.batch_size,
                                          cfg.img_size)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds, losses, launches = [], [], 0
    for i, batch in enumerate(batches):
        blue = i % 2 == 0
        closed = (1, 3) if blue else (0, 2)
        middle = {n: p for n, p in state.params.items()
                  if middle_block(n) is not None}
        frozen = {n: (p.detach().clone(),
                      {k: m.clone() for k, m in state.moments(n).items()})
                  for n, p in middle.items() if middle_block(n) in closed}
        opened = {n: p.detach().clone() for n, p in middle.items()
                  if middle_block(n) not in closed}
        att.reset_launch_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        counts = {k: n for k, n in att.launch_counts.items() if n}
        if counts != {"attention_fwd": 4}:
            fail(f"train step {i} launched the attention kernels {counts}, "
                 f"expected the bf16 kernel 4 times and no other")
        launches += counts["attention_fwd"]
        values = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in values.values()):
            fail(f"train step {i} gave non-finite metrics {values}")
        if values["underwater_gate"] != float(blue):
            fail(f"train step {i}: underwater_gate {values['underwater_gate']}"
                 f" on a {'blue' if blue else 'red'}-heavy batch")
        for n, (p, moments) in frozen.items():
            if not torch.equal(state.params[n], p) or not all(
                    torch.equal(state.moments(n)[k], m)
                    for k, m in moments.items()):
                fail(f"train step {i} moved gated-off parameter {n} or its "
                     f"AdamW moments")
        moved = {middle_block(n) for n, p in opened.items()
                 if not torch.equal(state.params[n], p)}
        if moved != {0, 1, 2, 3} - set(closed):
            fail(f"train step {i}: open middle blocks that moved {moved}, "
                 f"expected {sorted({0, 1, 2, 3} - set(closed))}")
        losses.append(values)
        print(f"  step {i} ({'blue' if blue else 'red'}): "
              f"{seconds[-1] * 1e3:.1f} ms " + json.dumps(values), flush=True)
    import statistics

    return dict(steps=len(batches), launches=launches,
                median_step_ms=statistics.median(seconds[1:]) * 1e3,
                step_ms=[x * 1e3 for x in seconds],
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                losses=losses, card=smi)


def phase_train_parity(torch, np):
    """One fp32 step at 64², batch 2, from the npz, dropout 0, fixed t and
    noise, on the card and on the CPU (and on the CPU from weights one ulp
    away, for κ, and on the card with TF32 on, to read beside the bound);
    returns the phase's record."""
    from hybrid_diffusion_tpu_torch.config import flagship_config
    from hybrid_diffusion_tpu_torch.diffusion import linear_beta_schedule
    from hybrid_diffusion_tpu_torch.profile_train import synthetic_batches
    from hybrid_diffusion_tpu_torch.train.loop import (
        create_train_state, init_params, make_dino)
    from hybrid_diffusion_tpu_torch.train.step import make_train_step

    cfg = flagship_config(img_size=64, bf16=False, dropout=0.0,
                          init_from_npz=str(FLAGSHIP_NPZ))
    batch = synthetic_batches(1, batch=2, size=64, seed=3)[0]
    rng = np.random.default_rng(4)
    t = torch.from_numpy(rng.integers(0, cfg.T, (2,)))
    noise = torch.from_numpy(rng.standard_normal((2, 64, 64, 3)).astype(
        np.float32))
    results = {}
    runs = (("cuda", False, False), ("cpu", False, False),
            ("cpu", True, False), ("cuda", False, True))
    for device, nudge, tf32 in runs:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        model = init_params(cfg, device)
        if nudge:
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(torch.from_numpy(1 + 2.0 ** -23 * rng.choice(
                        [-1.0, 1.0], tuple(p.shape))).float())
        state = create_train_state(cfg, model, steps_per_epoch=100)
        step = make_train_step(
            linear_beta_schedule(cfg.beta_1, cfg.beta_T, cfg.T),
            cfg.loss_config, dino_loss_fn=make_dino(cfg, device))
        state, metrics = step(state, batch, torch.Generator(device), t=t,
                              noise=noise)
        grads = torch.cat([p.grad.detach().flatten().cpu().double()
                           for p in state.params.values()])
        results[device, nudge, tf32] = (float(metrics["total"]), grads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = (results["cuda", False, False],
                                            results["cpu", False, False])
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_rel = float((g_gpu - g_cpu).norm() / g_cpu.norm())
    kappa = float((results["cpu", True, False][1] - g_cpu).norm()
                  / g_cpu.norm())
    loss_tf32, g_tf32 = results["cuda", False, True]
    grad_bound = max(TRAIN_GRAD_FLOOR, 10 * kappa)
    if not math.isfinite(loss_gpu) or loss_rel > TRAIN_LOSS_RTOL:
        fail(f"card fp32 train step loss {loss_gpu} vs CPU {loss_cpu}: rel "
             f"{loss_rel} > {TRAIN_LOSS_RTOL}")
    if not math.isfinite(grad_rel) or grad_rel > grad_bound:
        fail(f"card fp32 train step gradients differ from the CPU's by "
             f"{grad_rel} of their norm > {grad_bound} (kappa {kappa})")
    return dict(loss_card=loss_gpu, loss_cpu=loss_cpu, loss_rel=loss_rel,
                grad_rel=grad_rel, kappa=kappa, grad_bound=grad_bound,
                tf32_loss_rel=abs(loss_tf32 - loss_cpu) / abs(loss_cpu),
                tf32_grad_rel=float((g_tf32 - g_cpu).norm() / g_cpu.norm()))


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
    from hybrid_diffusion_tpu_torch.utils import cuda_build
    from hybrid_diffusion_tpu_torch.utils.timing import device_ms, host_ms
    from hybrid_diffusion_tpu_torch.weights import load_npz_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cuda_build.nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    phase_done("env", t0, f"python {sys.version.split()[0]} torch "
               f"{torch.__version__} cuda {torch.version.cuda} | {smi} | "
               f"TF32 off for matmul and cuDNN")

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    built = phase_build(att, cuda_build)
    phase_done("build", t0, f"nvcc {built.build_seconds:.2f}s, every "
               f"kernel on HMMA with no spills")

    # ---------------------------------------------------------------- kernel
    t0 = time.perf_counter()
    rows = phase_kernel(att, torch, device_ms, host_ms)
    grad_rows = phase_grad(att, torch, device_ms)
    phase_done("kernel", t0, "all shapes within tolerance, forward and "
               "backward")

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
    launches = att.launch_counts["attention_fwd"]
    calls = enh.device_calls - calls_before
    if launches != 20 * calls or att.launch_count != launches:
        fail(f"the attention kernels ran {att.launch_counts} times in {calls} "
             f"device calls on the main path, expected the tensor-core kernel "
             f"20 times per call and no other")
    n_img = sum(len(b) for b in requests)
    serve_s = sum(latencies)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del enh

    # The full-precision serving mode (bf16=False) at full width: one
    # request of 8 through the fp32 kernel.
    enh32 = Enhancer(flagship_config(bf16=False), FLAGSHIP_NPZ, max_batch=8,
                     device="cuda")
    att.reset_launch_count()
    t_req = time.perf_counter()
    outs = enh32.enhance(list(requests[0]))
    fp32_ms = (time.perf_counter() - t_req) * 1e3
    fp32_serve_launches = att.launch_counts["attention_fwd_fp32"]
    if fp32_serve_launches != 20 or att.launch_count != 20:
        fail(f"the fp32 request launched the kernels {att.launch_counts} "
             f"times, expected the fp32 kernel 20 times and no other")
    if len(outs) != 8 or int(np.ptp(np.stack(outs))) == 0:
        fail("the fp32 request gave no or constant outputs")
    del enh32
    phase_done("serve", t0, (
        f"bf16: {n_img} images in {calls} calls, {serve_s:.3f}s, "
        f"{n_img / serve_s:.2f} img/s, call latencies "
        f"{[round(x * 1e3, 1) for x in latencies]} ms, attention launches "
        f"{launches} ({launches // calls} per call), peak memory "
        f"{peak_gib:.2f} GiB; fp32: one call of 8 {fp32_ms:.1f} ms, "
        f"{fp32_serve_launches} fp32 attention launches | {smi}"))

    # ---------------------------------------------------------------- path
    t0 = time.perf_counter()
    cfg64 = flagship_config(img_size=64, bf16=False)
    state = load_npz_state_dict(FLAGSHIP_NPZ)
    rng = np.random.default_rng(1)
    cond = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    noise = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    outs = {}
    # (device, bf16, the kernel the card run must launch 20 times)
    for device, bf16, kernel in (("cuda", False, "attention_fwd_fp32"),
                                 ("cuda", True, "attention_fwd"),
                                 ("cpu", False, None)):
        cfg = dataclasses.replace(cfg64, bf16=bf16)
        model = build_model(cfg)
        model.load_state_dict(state, strict=True)
        model = model.to(device).eval()
        att.reset_launch_count()
        out = make_sampler(cfg, model)(
            torch.from_numpy(cond).to(device),
            init_noise=torch.from_numpy(noise).to(device))
        outs[device, bf16] = out.float().cpu().numpy().astype(np.float64)
        want = {kernel: 20} if kernel else {}
        if {k: n for k, n in att.launch_counts.items() if n} != want:
            fail(f"the {device} run (bf16={bf16}) launched the kernels "
                 f"{att.launch_counts} times, expected {want}")
    cpu = outs["cpu", False]
    detail = []
    for bf16, limit in ((False, PATH_PSNR_FP32_DB), (True, PATH_PSNR_BF16_DB)):
        gpu = outs["cuda", bf16]
        if gpu.shape != (2, 64, 64, 3) or not np.isfinite(gpu).all():
            fail(f"card output {gpu.shape} is not a finite (2, 64, 64, 3) "
                 f"image (bf16={bf16})")
        max_diff = float(np.abs(gpu - cpu).max())
        db = psnr(gpu, cpu)
        name = "bf16" if bf16 else "fp32"
        if db < limit:
            fail(f"card {name} vs CPU fp32 PSNR {db:.2f} dB < {limit} dB "
                 f"(max |diff| {max_diff})")
        detail.append(f"card {name} vs CPU fp32: max |diff| {max_diff:.3e}, "
                      f"PSNR {db:.2f} dB (limit {limit})")
    phase_done("path", t0, "64² batch 2 DPM++2M-5; " + "; ".join(detail))
    del state

    # ---------------------------------------------------------------- train
    t0 = time.perf_counter()
    train = phase_train(att, torch, np, smi)
    phase_done("train", t0, (
        f"{train['steps']} flagship steps (256², batch 16, bf16, "
        f"default loss with DINO): median step {train['median_step_ms']:.1f} "
        f"ms after the first, peak memory {train['peak_gib']:.2f} GiB, "
        f"attention launches {train['launches']} (4 per step) | {smi}"))

    # ---------------------------------------------------------------- tparity
    t0 = time.perf_counter()
    tp = phase_train_parity(torch, np)
    phase_done("tparity", t0, (
        f"fp32 64² batch 2 step, card vs CPU: loss rel {tp['loss_rel']:.3e} "
        f"(limit {TRAIN_LOSS_RTOL}), gradients rel {tp['grad_rel']:.3e} "
        f"(limit {tp['grad_bound']:.3e}, κ {tp['kappa']:.3e}); with TF32 "
        f"on: loss rel {tp['tf32_loss_rel']:.3e}, gradients rel "
        f"{tp['tf32_grad_rel']:.3e}"))

    # Each kernel at the shape the serve phase gave it, with its launches
    # there: bf16 in the bf16 calls, fp32 in the full-precision request.
    # The bf16 kernel also carries its launches in the train phase and its
    # forward + backward at the train shape; the fp32 one, at the tparity
    # phase's shape.
    kernels = []
    grad_of = {"attention_fwd": grad_rows[TRAIN_GRAD_CASES[0]],
               "attention_fwd_fp32": grad_rows[TRAIN_GRAD_CASES[1]]}
    for row, n in ((rows[SERVE_CASE], launches),
                   (rows[FP32_SERVE_CASE], fp32_serve_launches)):
        g = grad_of[row["kernel"]]
        kernels.append({
            "name": row["kernel"],
            "route": "cuda",
            "source": "hybrid_diffusion_tpu_torch/csrc/attention.cu",
            "replaces": "hybrid_diffusion_tpu/ops/attention.py:63",
            "launches": n,
            "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "train_launches": (train["launches"]
                               if row["kernel"] == "attention_fwd" else 0),
            "fwd_bwd_shape": [g["B"], g["N"], g["h"], g["d"]],
            "fwd_bwd_ms": g["fwd_bwd_ms"],
            "fwd_bwd_bound_ms": g["fwd_bwd_bound_ms"],
            "sdpa_fwd_bwd_ms": g["sdpa_fwd_bwd_ms"],
            "grad_max_abs_err": g["grad_max_abs_err"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
