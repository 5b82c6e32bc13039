#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

From a clean checkout, with no arguments, it:

  1. env    prints the Python, torch and CUDA versions and the card's name
            and power limit (nvidia-smi), and turns TF32 off for matmuls and
            cuDNN, so that every fp32 number below is full fp32;
  2. build  compiles the CUDA attention kernels with nvcc (or reuses the
            library built from the same source) and loads them; prints each
            of the 36 tensor-core kernel instances' registers and spills
            (ptxas) and its counts of the opcodes its route must show
            (cuobjdump -sass): HGMMA (wgmma), UTMALDG (TMA loads) and
            UTMASTG (TMA stores) for the wgmma forward and its lse instance
            in bf16 and fp16 at d 32 and 64 and for the bf16 wgmma backward
            at d 32, which also shows UTMAREDG (dQ's TMA reduce-add); HMMA
            (mma.sync) for the mma.sync forward and its lse instance at d 16
            and 32, the mma.sync backward at d 16, 32 and 64, for the fp32
            forward and its lse instance at d 16 and 32 with one and two m16
            tiles a warp and at d 64 with one, and for the fp32 backward at
            d 16, 32 and 64; fails if one lacks an opcode or spills, or if
            the backward's pre-pass or dQ conversion spills;
  3. kernel holds the kernels against their plain PyTorch version on the
            card at the shapes the serve, path, train, loop, eval and cfg
            phases give them (the loop's probe at its own batch, 9; the CFG
            model's four at 2B = 160, within CFG_RTOL of max|out|), at
            bf16 / fp16 / fp32, d = 16 / 64, a ragged N and inputs that
            catch a missing mask, and times kernel, plain version and
            scaled_dot_product_attention (CUDA events, median of 25, with
            the calls queued ahead of the card), and the wrapper's host time
            per call; prints the kernel that ran at each shape (the C
            dispatch's route: wgmma at d 32 from N 257, but not the fp16
            backward, and the forward at d 64; mma.sync elsewhere and in
            fp32) and
            the bound, the larger of the products at the type's peak and
            the bytes at the memory rate;
  4. serve  loads docs/assets/flagship256_r5_fp16.npz into an Enhancer (256²,
            max_batch 8, bf16, DPM++2M-5) and answers 3 requests of 8, 8
            and 3 images, checking outputs and that the bf16 kernel ran 20
            times per device call; then answers one request of 8 from an
            fp32 Enhancer (bf16=False), which must launch the fp32 kernel
            20 times, twice: with the caller's TF32 flags at PyTorch's
            defaults and with them off; the two must give the same bytes
            and leave the caller's flags as they were (the fp32 mode sets
            its own precision);
  5. export export_enhancer of the serve phase's bf16 Enhancer (the whole
            program, DPM++2M-5 at batch 8, as a torch.export artifact),
            load_exported, and one call of the loaded program: 20 launches
            of the bf16 kernel, its bytes within EXPORT_MAX_LEVELS of the
            Enhancer's on the same noise; prints the export's and load's
            seconds and both calls' times;
  6. http   serve_http on 127.0.0.1 (port 0) over a flagship Enhancer
            (max_batch 1): POST /enhance of a 256² PNG, a 300×200 one and a
            256² one with ?size=128x96 (20 launches each, the outputs at the
            asked sizes), /healthz, /stats and a bad body (a 4xx); prints
            each request's latency;
  7. path   runs the same weights at 64², batch 2, on one numpy initial
            noise through DPM++2M-5 on the card in fp32 (the fp32 kernel)
            and in bf16 (the bf16 kernel), 20 launches each, and on the CPU
            in fp32 (plain version), and requires PSNR ≥ 40 dB (fp32) and
            ≥ 38 dB (bf16) against the CPU; prints beside them the fp32
            sampler with cuDNN's TF32 on (what the fp32 mode gave before it
            set its own precision);
  8. train  takes TRAIN_STEPS training steps at the flagship width (256²,
            batch 16, bf16, the default composite loss with the DINO term
            on a random-init ViT-S at 252², dropout 0.15, domain routing,
            EMA 0.99875, lr 1e-5, warm-started from the r5 npz) on numpy
            batches that alternate blue- and red-heavy; each step must give
            finite losses, launch the bf16 forward and backward kernels 4
            times each and no other, and leave the gated-off middle blocks'
            parameters and
            AdamW moments bit for bit as they were while the open ones move;
            prints the median step time after the first, the peak memory
            and the card's nvidia-smi line;
  9. tparity one fp32 step (TF32 off) at 64², batch 2, from the npz, dropout
            0, fixed t and noise, on the card (the fp32 forward's lse
            instance and the fp32 backward kernel 4 times each) and on the
            CPU: the losses
            within TRAIN_LOSS_RTOL and the gradients' difference within
            max(TRAIN_GRAD_FLOOR, 10 κ) of their norm, κ being the CPU
            step's own change when every weight moves by one ulp; prints
            the same step on the card with the caller's TF32 on beside that
            bound (the step turns it off, so it reads as the fp32 one);
  10. loop  cli.main(--state train) at the flagship width on the synthetic
            corpus at 256² (64 train, 9 val, 18 test pairs a domain; batch
            16, bf16, the default loss with DINO, EMA 0.99875, lr 1e-5, the
            r5 warm start, one epoch a stage, the probe and a save every
            epoch, checkpoints and the export in a temporary directory it
            removes): every step 4 bf16 forward and 4 backward launches and
            finite losses, its
            batch and every parameter on the card, every probe call (DPM++2M-
            15) 60 launches, eval_curve.jsonl rows for both domains and
            stages, the stage-final checkpoints and the export's sidecar;
            then train(--resume_from auto) with a budget 2 steps past the
            saved step must continue from it; prints the step time inside
            train() (synchronized after each step), the gap between steps,
            the probe calls', saves' and exports' times;
  11. eval  cli.main(--state test) on that export with FID on (He-rescaled
            random Inception at 256²): finite metrics and FID for both
            domains, n_images the test split's, 20 launches a sampled
            batch; prints sample_wall_s, images/s, fetch_block_s and
            fid_block_s (the host's waits on the card);
  12. cfg   train_cfg at CFGConfig() (batch 80, 32², ch 128, mult
            (1, 2, 2, 2), 2 res blocks, T 500, bf16, the synthetic labeled
            set) for CFG_TRAIN_STEPS steps, 21 forward and 21 backward
            launches each (5 / 5 / 5 / 6 by shape at batch 80), then
            evaluate_cfg from its checkpoint over the whole T = 500 chain at
            w 1.8 on the 10 × 8 label grid: 500 calls of 2B = 160, each with
            21 launches, 5 / 5 / 5 / 6 at (N, d) = (1024, 16), (256, 32),
            (64, 32), (16, 32); prints the seconds, images/s and peak GiB;
            then the fp32 CFGUNet forward (batch 4) on the card against the
            CPU's on the same weights, within max(CFG_FWD_FLOOR, 10 κ);
  13. ddpm  the flagship npz at 64², batch 2, fp32, through make_sampler's
            ddpm branch over the full T = 1000 chain (4000 fp32 launches),
            finite and in range; one step (t = 999) card against CPU on
            injected noise within DDPM_STEP_RTOL;
  14. vgg   VGG_STEPS flagship-width bf16 steps (batch 16) under the
            run-book's stage-1 loss set (vgg 1, charbonnier 1, the rest 0)
            with vgg16 at random init: 4 forward and 4 backward launches
            a step, finite losses;
            prints the step time and peak memory;
  15. parallel  in spawned processes (this one holds no process group):
            two gloo ranks share cuda:0: a DDP step (mesh 2×1, global batch
            16 at 256², bf16, the default loss with DINO and MS-SSIM,
            dropout 0), a TP step (mesh 1×2, batch 8: the kernel on 4 heads) and a
            ZeRO-1 step (the forward and backward kernels 8 times each a
            rank), each held against one process on the same batch,
            t and noise (loss and gradient norm within PAR_BF16_RTOL), the
            three again in fp32 at 64² (loss within TRAIN_LOSS_RTOL, the
            first update's gradients within max(TRAIN_GRAD_FLOOR, 10 κ);
            each fp32 step launches the fp32 forward and backward kernels
            4 times each), and the batch-sharded sampler (DPM++2M-5,
            8 images, fp32 at 64²) against one process (±1 level on at most
            PAR_SAMPLE_MAX_SHARE of the bytes). Prints each rank's step
            times, peak memory and launches by shape, the collectives that
            gloo refuses on CUDA tensors and where they are checked
            instead. Two ranks sharing one card are no scaling figure.
  16. tools the port's tools, each as its own process (python -m
            hybrid_diffusion_tpu_torch...., as a user starts it): the bench
            at the flagship width (DDIM-100 sampling at 256², batch 16,
            bf16, BENCH_REPS 1: one JSON line, a finite positive img/s, 400
            attention launches a run, no backward; BENCH_MODE=train,
            BENCH_REPS 3: 4 forward and 4 backward launches a step), its
            JSON and `#` lines printed (its attention A/B, BENCH_MODE=attn,
            only re-times what the kernel phase times, and is held on the
            CPU by tests/test_torch_tools_bench.py);
            eval_flagship at the committed operating point
            (flagship256_r5_dpm5_eval.json's argv: the r5 npz, DPM++2M-5,
            73 val images a domain), its PSNR/SSIM printed beside the
            committed ones and at most EVAL_PSNR_GAP_DB below them;
            rescore_metrics of the images it saved (the same PSNR) and
            make_preview_grid of them; sweep_sampler over ddim:15 and
            dpm++2m:5; export_params of the loop phase's last checkpoint
            (auto subtree) and eval_flagship of that npz; demo_e2e (4
            steps, 64²), demo_staged (2 steps a stage), both evaluating
            with DDIM-10, demo_cfg (4 steps, a T 100 chain at w 0 and 1.8)
            and regen_cfg_grids of its cfg_params.npz, each writing JSON of
            finite values (exit 0, or 1 for a demo's own verdict: no
            traceback, and the verdict's keys in its JSON); all but the
            bench run at once, and beside them the parallel layer's NCCL
            part, one spawned rank on cuda:0 (this process holds no process
            group): cli train --zero1 at the flagship width for 2 steps
            with a save, a resume from it with --mesh_data 1 --mesh_model 1
            for 2 more, evaluate() of its final checkpoint, ring attention
            at world 1 against the plain version and one NCCL send/recv to
            itself.

The kernel phase also holds the attention's forward and gradients through
the autograd Function (the forward kernel's lse instance and the backward
kernel), on strided views of one packed projection, against the fp32 plain
version's autograd within the ops module's BWD_RTOL: in bf16 at the
training paths' shapes (the flagship step's (16, 1024, 8, 32), the CFG
step's four at batch 80, the head-sharded (8, 1024, 4, 32)), at the CFG
sampler's four at 2B = 160 and at ragged N = 1000 and 40 cases (bf16 and
fp16 at d 32, and fp16 on mask-trap inputs); in fp32 (3xTF32) at the
tparity shape (2, 64, 8, 32), the flagship and CFG train shapes in fp32
and ragged N = 1000 at d 32 and 64. It times forward + backward against
scaled_dot_product_attention's, and the backward kernel alone against its
plain twin and SDPA's backward alone.

Every phase prints one line with its seconds. The whole run must finish
within BUDGET_S; a phase that fails or ends past the budget stops the run
with a non-zero exit. The last lines are the kernels' JSON record (the
bf16 kernel's serve-shape row carries the bench's launches beside the serve
phase's, by mode, under bench_launches; the backward kernel has a row at
each training path's shape, the fp32 one at the tparity shape with its
times at the fp32 train shapes), the card's nvidia-smi line and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "hybrid_diffusion_tpu_torch"
FLAGSHIP_NPZ = ROOT / "docs" / "assets" / "flagship256_r5_fp16.npz"
BUDGET_S = 600.0
T_START = time.perf_counter()

# The bound (bound_ms) is the larger of two times: the products the
# function needs (4·B·h·N²·d forward) at the card's fastest rate for the
# type, fp32 products at the TF32 tensor cores' 495 TFLOP/s, not the FMA
# units' 67; and the bytes (each input read once, each output written once)
# at the memory rate (ops/attention.py: H100_PEAKS, bound_ms). The fp32
# kernel's own design, three TF32 products a product (3xTF32), has a floor
# three times the products', printed beside it (tf32x3_floor_ms) and not
# used as the bound: another split (for example fp16 parts with scaling)
# could need less.


# Kernel vs the fp32 plain version, max abs error, by dtype and inputs.
# bf16/fp16: the kernel rounds P to the input type before P·V and the output
# once. Its CPU emulation (tests/test_torch_attention_tiled.py) errs by at
# most 1.5e-3 (bf16) and 2.6e-4 (fp16) on random inputs at the shapes of
# KERNEL_CASES (|out| about 0.03 to 0.07 there), and by 4.1e-3 and 5.8e-4 on
# the mask-trap ones (|out| about 1), with the key tiles of the kernel the
# dispatch picks (128 keys on wgmma, 64 on mma.sync; 1.8e-3 in bf16 with 64
# everywhere). Each tolerance is that error times a margin of 4.3 to 5.6;
# it is not looser than the error calls for. An
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
# The parallel phase's head-sharded attention: the TP step (mesh 1×2, batch
# 8) runs the bf16 kernel on each rank's 4 of the 8 heads.
TP_CASE = (8, 1024, 4, 32, "bfloat16", "randn")
# The loop phase's probe (probe_case) gives the bf16 kernel its most
# frequent shape there: the first val batch of the synthetic corpus, fewer
# images than a train batch. phase_kernel holds it against the plain version
# beside KERNEL_CASES.
# (B, N, h, d, dtype, inputs) of the kernel phase. The ragged N = 1000 leaves
# 24 padded keys in the last tile: unmasked, they would dilute the softmax
# by ~1.5% (errors ~4e-3), far past the fp32 tolerance; the mask-trap inputs
# make the same fault an error of ~1 in bf16 and fp16.
KERNEL_CASES = [
    SERVE_CASE,
    PATH_CASE,
    FP32_SERVE_CASE,
    TRAIN_CASE,
    TP_CASE,
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
    # fp16 at d 32 and a ragged N of 40: the fp16 mma.sync instance, whose
    # one 64-key tile holds 24 padded keys (the mask trap's error ~1).
    (2, 40, 8, 32, "float16", "mask trap"),
]

# The fp32 backward kernel's gradient cases: the tparity phase's shape (64²,
# batch 2: N 8·8), the flagship train step's and the CFG step's at N 1024 in
# fp32 (bf16=False), and ragged N = 1000 at d 32 and 64. Held, as the 16-bit
# backward is, against the fp32 plain version's autograd within
# att.BWD_RTOL["float32", "randn"] (2e-5 of each gradient's largest value,
# derived in ops/attention.py from the kernel's CPU emulation; dQ's atomics
# reorder its fp32 sums from run to run).
FP32_GRAD_CASE = (2, 64, 8, 32, "float32", "randn")
FP32_TRAIN_CASE = (16, 1024, 8, 32, "float32", "randn")
FP32_CFG_TRAIN_CASE = (80, 1024, 8, 16, "float32", "randn")
FP32_RAGGED_GRAD_CASES = [(4, 1000, 8, 32, "float32", "randn"),
                          (2, 1000, 8, 64, "float32", "randn")]
FP32_GRAD_CASES = ([FP32_GRAD_CASE, FP32_TRAIN_CASE, FP32_CFG_TRAIN_CASE]
                   + FP32_RAGGED_GRAD_CASES)

# The train phase's steps (the first one warms up and is left out of the
# median); its settings are profile_train.py's FINE_TUNE: batch 16, the r5
# flagship's EMA decay and warm-start lr, dropout 0.15.
TRAIN_STEPS = 5
# A flagship bf16 training step (the 4 middle blocks' attention): the
# forward kernel (its lse instance) and the backward kernel 4 times each.
TRAIN_STEP_LAUNCHES = {"attention_fwd": 4, "attention_bwd": 4}
# An fp32 step (bf16=False: tparity, the parallel phase's fp32 steps): the
# fp32 forward's lse instance and the fp32 backward kernel 4 times each.
FP32_STEP_LAUNCHES = {"attention_fwd_fp32": 4, "attention_bwd_fp32": 4}
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
# The loop and eval phases' synthetic corpus: 64 train, 9 val and 18 test
# pairs a domain (data/datasets.py::make_dataset).
LOOP_SYNTHETIC_LENGTH = 64

# The cfg phase: CFGConfig() defaults (32², ch 128, mult (1, 2, 2, 2), 2 res
# blocks, 8 heads, T 500, bf16, batch 80), the synthetic labeled set. One
# CFGUNet call under guidance runs 2B = 160 images (the 10 × 8 label grid)
# and launches the attention kernel 21 times: (N, d) -> launches a call.
CFG_TRAIN_STEPS = 4
CFG_BATCH = 160
CFG_SHAPES = {(1024, 16): 5, (256, 32): 5, (64, 32): 5, (16, 32): 6}
CFG_CASES = [(CFG_BATCH, N, 8, d, "bfloat16", "randn") for N, d in CFG_SHAPES]
# Their tolerance is relative to the largest output: at N 16 the outputs
# reach about 2.2 (an average of 16 values), where half a unit in bf16's
# last place is 2^-8, not the 0.03-0.07 of N 1024 that ATOL was set for.
# The CPU emulation of the kernel errs by at most 3.4e-3 of max|out| at
# these shapes (tests/test_torch_cfg.py); 2^-6 is 4.6 times that.
CFG_RTOL = 2.0 ** -6
# The backward kernel (bf16/fp16) at the shapes the training paths give it:
# the train phase's flagship step, the cfg phase's train step (batch 80,
# its four (N, d)) and the parallel phase's TP step (4 heads); at the CFG
# sampler's 2B = 160 (forward + backward against SDPA's, as before the
# backward kernel); and four ragged cases: N = 1000 in bf16 and fp16 at d
# 32, and in fp16 at d 64 on mask-trap inputs, where a padded key that kept
# its P (about 2^33, past fp16's range) or a query past N that read another
# row's lse would make the gradients non-finite; N = 40 in fp16 at d 32 on
# mask-trap inputs, the fp16 mma.sync instances (forward with lse, backward). Each is held against the fp32
# plain version's autograd (and the forward at ATOL, or CFG_RTOL at the CFG
# shapes), within att.BWD_RTOL (ops/attention.py, derived there from the
# kernel's CPU emulation) of each gradient's largest value
# (att.grad_rel_err); on the mask trap, of the largest of the three. There
# every key shares a component of −30/√d along q, so dQ = Σ dS·K is a
# near-cancellation, and FA2's D = rowsum(dO∘O), from the output rounded to
# the input type, leaks its rounding times that shared key into dQ (the CPU
# emulation errs by 1.65 of max|dQ| in fp16, as does the plain twin; the
# input-dtype plain autograd, which sums P∘dP, by 5e-3). So the mask trap
# shows finite gradients and masked padded keys, and the fp16 random case
# holds fp16's dQ to its own scale.
CFG_TRAIN_BATCH = 80
CFG_TRAIN_CASES = [(CFG_TRAIN_BATCH, N, 8, d, "bfloat16", "randn")
                   for N, d in CFG_SHAPES]
RAGGED_GRAD_CASES = [(4, 1000, 8, 32, "bfloat16", "randn"),
                     (4, 1000, 8, 32, "float16", "randn"),
                     (2, 1000, 8, 64, "float16", "mask trap"),
                     (2, 40, 8, 32, "float16", "mask trap")]
KERNEL_GRAD_CASES = ([TRAIN_CASE] + CFG_TRAIN_CASES + CFG_CASES + [TP_CASE]
                     + RAGGED_GRAD_CASES)
# The cfg phase's card-vs-CPU fp32 forward (batch 4, the trained weights):
# within max(CFG_FWD_FLOOR, 10 κ) of max|CPU|, κ the CPU forward's own
# change when every weight moves by one ulp.
CFG_FWD_FLOOR = 1e-4
# The ddpm phase's one step on injected noise, card against CPU in fp32:
# the step scales ε by coeff2 (0.02 at t = 999), so ε's own rounding
# (rel ~1e-6, the path phase's fp32 PSNR) moves it by ~1e-8 of its size.
DDPM_STEP_RTOL = 1e-5
# The vgg phase: flagship-width bf16 steps under the run-book's stage-1 loss
# set, vgg16 at random init.
VGG_STEPS = 3
STAGE1_LOSSES = "vgg=1.0,charbonnier=1.0,dino=0,ms_ssim=0,color=0"
# The export phase: the loaded artifact runs the same kernels on the same
# inputs in the same order as the Enhancer, so its bytes should be equal;
# one uint8 level is allowed where a decomposed op (the export's ATen graph)
# sums in another order and a value crosses a quantization boundary.
EXPORT_MAX_LEVELS = 1


def mask_trap_qkv(rng, B: int, N: int, h: int, d: int):
    """Packed (B, N, 3, h, d) float32 q|k|v whose every real score
    q·k/√d is about −30 (q ≈ 1, k ≈ −30/√d), with v ≈ 1. A zero-filled
    padded key that escaped the mask would score 0 and, with v 0, take
    nearly all the weight: an error of about 1."""
    import numpy as np

    noise = 0.1 * rng.standard_normal((B, N, 3, h, d))
    centre = np.array([1.0, -30.0 / math.sqrt(d), 1.0])[:, None, None]
    return (centre + noise).astype(np.float32)


# PyTorch's defaults: (matmul, cuDNN) TF32 flags.
TF32_DEFAULTS = (False, True)


def tf32_flags(torch) -> tuple:
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def set_tf32(torch, flags: tuple) -> None:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        flags


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


# The SASS opcodes each route's instances must show (cuobjdump -sass; names
# as the H100's toolkit prints them): wgmma instances HGMMA and the TMA
# loads and stores, the wgmma backward also dQ's TMA reduce-add; mma.sync
# and the fp32 3xTF32 instances HMMA.
ROUTE_OPCODES = {
    "attention_fwd_wgmma_kernel": ("HGMMA", "UTMALDG", "UTMASTG"),
    "attention_bwd_wgmma_kernel": ("HGMMA", "UTMALDG", "UTMASTG", "UTMAREDG"),
    "attention_fwd_mma_kernel": ("HMMA",),
    "attention_bwd_mma_kernel": ("HMMA",),
    "attention_fwd_tf32_kernel": ("HMMA",),
    "attention_bwd_tf32_kernel": ("HMMA",),
}
# In bf16 and fp16: the wgmma forward and its lse instance at d 32 and 64
# (8), the mma.sync forward and its lse instance at d 16 and 32 (8), the
# mma.sync backward at d 16, 32, 64 (6); in bf16 the wgmma backward at d 32
# (1); fp32: the forward and its lse instance at d 16 and 32 with one and
# two m16 tiles a warp (8) and at d 64 with one (2), the backward at d 16,
# 32, 64 (3).
TENSOR_CORE_INSTANCES = 36


def phase_build(att, cuda_build):
    """Build and load the library; check its kernels' resources and that
    every kernel instance shows its route's opcodes (tensor cores, TMA)."""
    built = att.load_kernel()
    resources = cuda_build.kernel_resources(built.ptxas_log)
    opcodes = sorted({op for ops in ROUTE_OPCODES.values() for op in ops})
    try:
        cuobjdump = cuda_build.find_cuobjdump()
        table = cuda_build.sass_opcode_table(built.path, opcodes)
    except (RuntimeError, OSError) as e:
        fail(f"cannot count the kernels' instructions: {e}")
    notes = cuda_build.wgmma_serialization_notes(built.ptxas_log)
    print(f"  nvcc {built.build_seconds:.2f}s cached={built.cached} "
          f"{built.path.name}; SASS read with {cuobjdump}", flush=True)
    tensor_core = 0
    for sym, res in sorted(resources.items()):
        inst = att.kernel_instance(sym)
        if inst is None:
            continue
        name, dtype, d = inst
        need = ROUTE_OPCODES[name.split("/")[0]]
        counts = {op: table.get(sym, {}).get(op, 0) for op in need}
        print(f"  {name}<{str(dtype).split('.')[-1]}, d {d}>: "
              f"{res.registers} registers, {res.spill_bytes} bytes spilled, "
              + ", ".join(f"{n} {op}" for op, n in counts.items())
              + (f", ptxas serialized its wgmma ({', '.join(notes[sym])})"
                 if sym in notes else ""), flush=True)
        tensor_core += 1
        if not all(counts.values()) or res.spill_bytes:
            fail(f"{name}<{dtype}, {d}> has opcodes {counts} (each must be "
                 f"there) and spills {res.spill_bytes} bytes")
    if tensor_core != TENSOR_CORE_INSTANCES:
        fail(f"found {tensor_core} tensor-core kernel instances in ptxas's "
             f"report, expected {TENSOR_CORE_INSTANCES} (in bf16 and fp16: "
             f"the wgmma forward and its lse instance at d 32, 64, the "
             f"mma.sync forward and its lse instance at d 16, 32, the "
             f"mma.sync backward at d 16, 32, 64; in bf16 the wgmma backward "
             f"at d 32; fp32: the forward and its lse instance twice at d 16 "
             f"and 32 and once at d 64, the backward at d 16, 32, 64)")
    for sym, res in sorted(resources.items()):
        if "attention_bwd_" in sym and res.spill_bytes:
            fail(f"{sym} spills {res.spill_bytes} bytes")
    return built


def probe_case() -> tuple:
    """The attention shape of the loop phase's probe calls: its first
    eval_probe_batches val batches of the synthetic corpus at 256², each
    min(val pairs, batch) images (9 of 16 at LOOP_SYNTHETIC_LENGTH 64)."""
    from hybrid_diffusion_tpu_torch.config import parse_config
    from hybrid_diffusion_tpu_torch.data.datasets import make_dataset

    config = parse_config(loop_argv(Path("unused")))
    if config.eval_probe_batches != 1:
        fail(f"probe_case assumes one probe batch, the loop phase takes "
             f"{config.eval_probe_batches}")
    n_val = len(make_dataset("synthetic-underwater", "val",
                             synthetic_length=LOOP_SYNTHETIC_LENGTH))
    return (min(n_val, config.batch_size),) + TRAIN_CASE[1:]


def phase_kernel(att, torch, device_ms, host_ms):
    """Kernels vs their plain version on the card, at KERNEL_CASES, the
    probe's shape and the CFG shapes; returns the rows."""
    import numpy as np
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    rows = {}
    for case in KERNEL_CASES + [probe_case()] + CFG_CASES:
        B, N, h, d, dname, inputs = case
        dtype = getattr(torch, dname)
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
        atol = (CFG_RTOL * ref.abs().max().item() if case in CFG_CASES
                else ATOL[dname, inputs])
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
        bound_ms, bound_by = att.bound_ms(
            flops, 4.0 * B * N * h * d * q.element_size(), dname)
        row = dict(B=B, N=N, h=h, d=d, dtype=dname, inputs=inputs,
                   kernel=att.KERNEL_BY_DTYPE[dtype],
                   route=att.kernel_route(dtype, N, d),
                   max_abs_err=err, tol=atol, kernel_ms=kernel_ms,
                   kernel_host_ms=kernel_host_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        if dname == "float32":
            row["tf32x3_floor_ms"] = (3 * flops / att.H100_PEAKS["flops"][dname]
                                      * 1e3)
        print("  kernel " + json.dumps(row), flush=True)
        rows[case] = row
    return rows


def phase_grad(att, torch, device_ms):
    """The attention's gradients through the autograd Function (the forward
    kernel's lse instance and the backward kernel), on strided views of one
    packed projection, against the fp32 plain version's autograd at
    FP32_GRAD_CASES (fp32) and KERNEL_GRAD_CASES (bf16, fp16). Times forward
    + backward against SDPA's, and the backward kernel alone against its
    plain twin and SDPA's backward alone (its forward once, then the
    backward with retain_graph). Returns rows by case."""
    import numpy as np
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(1)
    rng = np.random.default_rng(1)
    rows = {}
    for case in FP32_GRAD_CASES + KERNEL_GRAD_CASES:
        if case in rows:
            continue
        B, N, h, d, dname, inputs = case
        dtype = getattr(torch, dname)
        if inputs == "randn":
            qkv = torch.randn(B, N, 3, h, d, device="cuda", generator=gen)
        else:
            qkv = torch.from_numpy(mask_trap_qkv(rng, B, N, h, d)).cuda()
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

        before = dict(att.launch_counts)
        out, grad = kernel_fwd_bwd()
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in att.launch_counts.items()
                    if n != before[k]}
        want = {att.KERNEL_BY_DTYPE[dtype]: 1,
                att.BACKWARD_KERNEL_BY_DTYPE[dtype]: 1}
        if launched != want:
            fail(f"forward + backward at {case} launched {launched}, "
                 f"expected {want}")
        with torch.no_grad():
            fwd_ref = att.attention_reference(
                *qkv.detach().float().unbind(2))
        fwd_err = (out.detach().float() - fwd_ref).abs().max().item()
        fwd_tol = (CFG_RTOL * fwd_ref.abs().max().item()
                   if (N, d) in CFG_SHAPES and dname == "bfloat16"
                   else ATOL[dname, inputs])
        if not math.isfinite(fwd_err) or fwd_err > fwd_tol:
            fail(f"the Function's forward (the kernel) disagrees with the "
                 f"fp32 plain version at {case}: max_abs_err {fwd_err} > "
                 f"{fwd_tol}")
        x32 = qkv.detach().float().requires_grad_()
        _, ref32 = plain_fwd_bwd(x32, g.float())
        _, ref_same = plain_fwd_bwd()
        common = inputs == "mask trap"
        rel32 = att.grad_rel_err(grad.unbind(2), ref32.unbind(2), common)
        rel_same = att.grad_rel_err(grad.unbind(2), ref_same.unbind(2),
                                    common)
        _, sdpa_grad = sdpa_fwd_bwd()
        err, tol = rel32, att.BWD_RTOL[dname, inputs]
        if not math.isfinite(err) or err > tol:
            fail(f"attention gradients through the kernels disagree with the "
                 f"plain version's at {case}: grad_rel_err {err} > {tol}")
        row = dict(B=B, N=N, h=h, d=d, dtype=dname, inputs=inputs,
                   fwd_max_abs_err=fwd_err, fwd_tol=fwd_tol,
                   grad_rel_err=err, grad_tol=tol,
                   grad_rel_err_vs_fp32=rel32,
                   grad_rel_err_vs_same_dtype=rel_same,
                   sdpa_grad_rel_err_vs_fp32=att.grad_rel_err(
                       sdpa_grad.unbind(2), ref32.unbind(2), common),
                   grad_max_abs_err=(grad.float() - ref32).abs().max().item())
        timed = case not in RAGGED_GRAD_CASES + FP32_RAGGED_GRAD_CASES
        # The backward kernel alone, on the forward's own out and lse;
        # twice, for the run-to-run spread of dQ's atomic sums.
        q, k, v = qkv.detach().unbind(2)
        o, lse = att.attention_forward_lse(q, k, v)
        grads = att.attention_backward(q, k, v, o, lse, g)
        again = att.attention_backward(q, k, v, o, lse, g)
        twin = att.attention_backward_reference(q, k, v, o, lse, g)
        row.update(
            twin_rel_err=att.grad_rel_err(grads, twin, common),
            dq_spread=(grads[0] - again[0]).float().abs().max().item(),
            dq_spread_rel=att.grad_rel_err(again[:1], grads[:1]),
            dkdv_equal=all(torch.equal(a, b) for a, b in
                           zip(grads[1:], again[1:])))
        if timed:
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            s_out = F.scaled_dot_product_attention(qt, kt, vt)
            gt = g.transpose(1, 2)
            # The function's inputs are q, k, v, out, lse and dout: it
            # forms S again (2 N²d), dP, dV, dK and dQ (2 N²d each).
            bwd_bound_ms, bwd_bound_by = att.bound_ms(
                10.0 * B * h * N * N * d,
                8.0 * B * N * h * d * q.element_size() + 4.0 * B * h * N,
                dname)
            row.update(
                bwd_route=att.kernel_route(dtype, N, d, backward=True),
                bwd_ms=device_ms(lambda: att.attention_backward(
                    q, k, v, o, lse, g), reps=15, inner=5),
                plain_bwd_ms=device_ms(
                    lambda: att.attention_backward_reference(
                        q, k, v, o, lse, g), reps=5, inner=2),
                sdpa_bwd_ms=device_ms(lambda: torch.autograd.grad(
                    s_out, (qt, kt, vt), gt, retain_graph=True),
                    reps=15, inner=5),
                bwd_bound_ms=bwd_bound_ms, bwd_bound_by=bwd_bound_by)
            if dname == "float32":  # three TF32 products a product
                row["bwd_tf32x3_floor_ms"] = (
                    30.0 * B * h * N * N * d
                    / att.H100_PEAKS["flops"][dname] * 1e3)
            del s_out
        if timed:
            # forward 4 N²d products, its vjp 8
            fwd_bwd_bound_ms, fwd_bwd_bound_by = att.bound_ms(
                12.0 * B * h * N * N * d,
                8.0 * B * N * h * d * qkv.element_size(), dname)
            row.update(
                fwd_bwd_ms=device_ms(kernel_fwd_bwd, reps=15, inner=5),
                plain_fwd_bwd_ms=device_ms(plain_fwd_bwd, reps=5, inner=2),
                sdpa_fwd_bwd_ms=device_ms(sdpa_fwd_bwd, reps=15, inner=5),
                fwd_bwd_bound_ms=fwd_bwd_bound_ms,
                fwd_bwd_bound_by=fwd_bwd_bound_by)
        print("  grad " + json.dumps(row), flush=True)
        rows[case] = row
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
    seconds, losses, launches, bwd_launches = [], [], 0, 0
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
        if counts != TRAIN_STEP_LAUNCHES:
            fail(f"train step {i} launched the attention kernels {counts}, "
                 f"expected {TRAIN_STEP_LAUNCHES}")
        launches += counts["attention_fwd"]
        bwd_launches += counts["attention_bwd"]
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
                bwd_launches=bwd_launches,
                median_step_ms=statistics.median(seconds[1:]) * 1e3,
                step_ms=[x * 1e3 for x in seconds],
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                losses=losses, card=smi)


def phase_train_parity(att, torch, np):
    """One fp32 step at 64², batch 2, from the npz, dropout 0, fixed t and
    noise, on the card and on the CPU (and on the CPU from weights one ulp
    away, for κ, and on the card with TF32 on, to read beside the bound);
    each card step must launch the fp32 forward (its lse instance) and the
    fp32 backward kernel 4 times each (the middle blocks' attention) and no
    other; returns the phase's record."""
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
    launches = bwd_launches = 0
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
        att.reset_launch_count()
        state, metrics = step(state, batch, torch.Generator(device), t=t,
                              noise=noise)
        counts = {k: n for k, n in att.launch_counts.items() if n}
        want = FP32_STEP_LAUNCHES if device == "cuda" else {}
        if counts != want:
            fail(f"the fp32 step on {device} (TF32 {tf32}) launched the "
                 f"attention kernels {counts}, expected {want}")
        launches += counts.get("attention_fwd_fp32", 0)
        bwd_launches += counts.get("attention_bwd_fp32", 0)
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
                launches=launches, bwd_launches=bwd_launches,
                tf32_loss_rel=abs(loss_tf32 - loss_cpu) / abs(loss_cpu),
                tf32_grad_rel=float((g_tf32 - g_cpu).norm() / g_cpu.norm()))


class LoopRecorder:
    """Wraps the loop's step, sampler and checkpoint save to record, per
    call, the kernels' launches, its host time (ending in a synchronize),
    the devices of the batch and the model, and the step's metrics."""

    def __init__(self, att, torch, loop, sync_samples: bool = True):
        self.att, self.torch, self.loop = att, torch, loop
        self.sync_samples = sync_samples
        self.steps, self.samples, self.saves = [], [], []
        self.real = {name: getattr(loop, name) for name in
                     ("make_train_step", "make_sampler", "save_checkpoint")}
        loop.make_train_step = self._make_train_step
        loop.make_sampler = self._make_sampler
        loop.save_checkpoint = self._save_checkpoint

    def restore(self) -> None:
        for name, fn in self.real.items():
            setattr(self.loop, name, fn)

    def _timed(self, fn, *args, sync: bool = True, **kwargs):
        torch, att = self.torch, self.att
        if sync:
            torch.cuda.synchronize()
        before = dict(att.launch_counts)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = {k: n - before[k] for k, n in att.launch_counts.items()
                    if n != before[k]}
        return out, launches, t0, t1

    def _make_train_step(self, *args, **kwargs):
        step = self.real["make_train_step"](*args, **kwargs)

        def recorded(state, batch, generator):
            (state, metrics), launches, t0, t1 = self._timed(
                step, state, batch, generator)
            self.steps.append(dict(
                launches=launches, t0=t0, t1=t1,
                metrics={k: float(v) for k, v in metrics.items()},
                batch_on_cuda=all(v.is_cuda for v in batch.values()),
                params_on_cuda=all(p.is_cuda for p in state.params.values())))
            return state, metrics

        return recorded

    def _make_sampler(self, *args, **kwargs):
        sample = self.real["make_sampler"](*args, **kwargs)

        def recorded(cond_u8, generator=None, init_noise=None):
            out, launches, t0, t1 = self._timed(sample, cond_u8, generator,
                                                init_noise,
                                                sync=self.sync_samples)
            self.samples.append(dict(launches=launches, ms=(t1 - t0) * 1e3,
                                     batch=cond_u8.shape[0]))
            return out

        return recorded

    def _save_checkpoint(self, *args, **kwargs):
        import os

        path, _, t0, t1 = self._timed(self.real["save_checkpoint"], *args,
                                      **kwargs)
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        self.saves.append(dict(path=path, ms=(t1 - t0) * 1e3,
                               gib=size / 2**30))
        return path


def loop_argv(tmp: Path) -> list:
    """The loop phase's command line: the flagship width, the synthetic
    corpus at 256², batch 16, bf16, the default loss with DINO, EMA
    0.99875, lr 1e-5, warm-started from the r5 npz, one epoch a stage,
    the probe and a save every epoch, the export and checkpoints in tmp."""
    return ["--state", "train", "--device", "cuda", "--synthetic_data",
            "--synthetic_length", str(LOOP_SYNTHETIC_LENGTH),
            "--img_size", "256", "--batch_size", "16", "--bf16",
            "--ema_decay", "0.99875", "--lr", "1e-5",
            "--init_from_npz", str(FLAGSHIP_NPZ),
            "--epochs_stage_1", "1", "--epochs_stage_2", "1",
            "--eval_every", "1", "--save_checkpoint", "1",
            "--sampler", "dpm++2m", "--ddim_step", "5",
            "--export_npz", str(tmp / "export.npz"),
            "--checkpoint_dir", str(tmp / "ck"),
            "--output_path", str(tmp / "out")]


def phase_loop(att, torch, np, tmp: Path) -> dict:
    """`cli.main` trains both stages at the flagship width, then a second
    run resumes with --resume_from auto and a larger budget; returns the
    phase's record."""
    import statistics

    from hybrid_diffusion_tpu_torch import cli
    from hybrid_diffusion_tpu_torch.config import parse_config
    from hybrid_diffusion_tpu_torch.data.datasets import make_dataset
    from hybrid_diffusion_tpu_torch.train import checkpoint, loop

    argv = loop_argv(tmp)
    batch = parse_config(argv).batch_size
    train_len = len(make_dataset("synthetic-underwater", "train",
                                 synthetic_length=LOOP_SYNTHETIC_LENGTH))
    steps_per_stage = -(-train_len // batch)
    rec = LoopRecorder(att, torch, loop)
    att.reset_launch_count()
    try:
        if cli.main(argv) != 0:
            fail("cli.main(--state train) returned non-zero")
        first = dict(steps=list(rec.steps), samples=list(rec.samples),
                     saves=list(rec.saves))
        rows = [json.loads(line) for line in
                open(tmp / "out" / "eval_curve.jsonl")]
        rec.steps.clear(), rec.samples.clear(), rec.saves.clear()
        resume = parse_config(argv + ["--resume_from", "auto"])
        summary = loop.train(resume, max_steps=steps_per_stage + 2)
    finally:
        rec.restore()
    loop_launches = att.launch_counts["attention_fwd"]
    loop_bwd_launches = att.launch_counts["attention_bwd"]
    if att.launch_count != loop_launches + loop_bwd_launches:
        fail(f"the loop launched {att.launch_counts}, expected only the bf16 "
             f"kernels")
    steps = first["steps"]
    if len(steps) != 2 * steps_per_stage:
        fail(f"the first run took {len(steps)} steps, expected "
             f"{steps_per_stage} in each of two stages")
    for i, st in enumerate(steps + rec.steps):
        if st["launches"] != TRAIN_STEP_LAUNCHES:
            fail(f"loop step {i} launched {st['launches']}, expected "
                 f"{TRAIN_STEP_LAUNCHES}")
        if not all(math.isfinite(v) for v in st["metrics"].values()):
            fail(f"loop step {i} gave non-finite metrics {st['metrics']}")
        if not (st["batch_on_cuda"] and st["params_on_cuda"]):
            fail(f"loop step {i}: a batch or a parameter is not on the card")
    probe_steps = 15
    probes = first["samples"]
    if len(probes) != 8 or any(p["launches"] != {"attention_fwd": 4 * probe_steps}
                               for p in probes):
        fail(f"the probes made {len(probes)} sampler calls with launches "
             f"{[p['launches'] for p in probes]}, expected 8 (2 stages × 2 "
             f"domains × raw and EMA) of {4 * probe_steps}")
    probe_b = probe_case()[0]
    if any(p["batch"] != probe_b for p in probes):
        fail(f"probe batches {[p['batch'] for p in probes]}, the kernel phase "
             f"checked the probe's shape at batch {probe_b}")
    if sorted((r["stage"], r["domain"]) for r in rows) != sorted(
            (s, d) for s in ("Atmospheric", "Underwater")
            for d in ("atmospheric", "underwater")):
        fail(f"eval_curve.jsonl rows {[(r['stage'], r['domain']) for r in rows]}")
    if not all(math.isfinite(r["psnr"]) and math.isfinite(r["psnr_ema"])
               for r in rows):
        fail(f"the probe gave non-finite PSNRs {rows}")
    names = sorted(p.name for p in (tmp / "ck").iterdir())
    for stage in ("Atmospheric", "Underwater"):
        want = f"ckpt_1_{stage}_final_"
        if not any(n.startswith(want) and n.endswith("_HICRDLoLI")
                   for n in names):
            fail(f"no stage-final checkpoint {want}<run id>_HICRDLoLI in "
                 f"{names}")
    side = json.loads((tmp / "export.npz.json").read_text())
    if side.get("subtree") not in ("params", "ema_params") \
            or not (tmp / "export.npz").is_file():
        fail(f"the exported npz's sidecar names no subtree: {side}")
    state = summary["state"]
    final = checkpoint.load_metadata(summary["stages"][-1]["checkpoint"])
    if (summary["steps"] != steps_per_stage + 2 or len(rec.steps) != 2
            or state.step != steps_per_stage + 2 or final["step"] != state.step
            or [s["stage"] for s in summary["stages"]] != ["Underwater"]):
        fail(f"the resumed run did not continue from step {steps_per_stage}: "
             f"{len(rec.steps)} steps, summary {summary['steps']}, state "
             f"step {state.step}, checkpoint step {final['step']}")
    ms = [(st["t1"] - st["t0"]) * 1e3 for st in steps]
    gaps = [(b["t0"] - a["t1"]) * 1e3 for a, b in zip(steps, steps[1:])
            if a is not steps[steps_per_stage - 1]]
    periodic = [s for s in first["saves"] if "_final_" not in s["path"]]
    return dict(steps=len(steps), resumed_steps=len(rec.steps),
                launches=loop_launches, bwd_launches=loop_bwd_launches,
                median_step_ms=statistics.median(ms[1:]),
                step_ms=ms, median_gap_ms=statistics.median(gaps),
                gap_ms=gaps,
                probe_call_ms=[p["ms"] for p in probes],
                probe_batch=probes[0]["batch"],
                save_ms=[s["ms"] for s in first["saves"]],
                save_gib=periodic[0]["gib"],
                probe_rows=rows, export=side["subtree"],
                resumed_from=steps_per_stage,
                last_checkpoint=summary["stages"][-1]["checkpoint"])


def phase_eval(att, torch, np, tmp: Path) -> dict:
    """`cli.main(--state test)` on the loop's export with the He-rescaled
    random Inception FID at 256²; returns evaluate()'s results and the
    sampler's launches."""
    from hybrid_diffusion_tpu_torch import cli
    from hybrid_diffusion_tpu_torch.config import parse_config
    from hybrid_diffusion_tpu_torch.data.datasets import make_dataset
    from hybrid_diffusion_tpu_torch.train import loop

    argv = [a if a != "train" else "test" for a in loop_argv(tmp)]
    argv += ["--pretrained_path", str(tmp / "export.npz")]
    batch = parse_config(argv).batch_size
    n_test = len(make_dataset("synthetic-underwater", "test",
                              synthetic_length=LOOP_SYNTHETIC_LENGTH))
    # No synchronize around the sampler: evaluate() keeps two batches in
    # flight, and its own clocks (sample_wall_s, fetch_block_s) are read.
    rec = LoopRecorder(att, torch, loop, sync_samples=False)
    real_evaluate = loop.evaluate
    results = {}

    def captured(*args, **kwargs):
        results.update(real_evaluate(*args, **kwargs))
        return results

    loop.evaluate = captured
    att.reset_launch_count()
    try:
        if cli.main(argv) != 0:
            fail("cli.main(--state test) returned non-zero")
    finally:
        loop.evaluate = real_evaluate
        rec.restore()
    batches = 2 * -(-n_test // batch)
    if len(rec.samples) != batches or any(
            s["launches"] != {"attention_fwd": 20} for s in rec.samples):
        fail(f"evaluate made {len(rec.samples)} sampler calls with launches "
             f"{[s['launches'] for s in rec.samples]}, expected {batches} of "
             f"20 (DPM++2M-5)")
    for domain in ("underwater", "atmospheric"):
        res = results.get(domain, {})
        if res.get("n_images") != n_test:
            fail(f"{domain}: n_images {res.get('n_images')}, the test split "
                 f"has {n_test}")
        for k in ("psnr", "ssim", "uiqm", "uciqe", "uism", "uicm", "uiconm",
                  "uiqm_nd", "fid"):
            if not math.isfinite(res.get(k, float("nan"))):
                fail(f"{domain}: {k} = {res.get(k)} is not finite")
        if res.get("fid_pretrained") != 0.0:
            fail(f"{domain}: expected the He-rescaled random FID")
        if not res.get("fid_block_s", -1.0) >= 0.0:
            fail(f"{domain}: fid_block_s {res.get('fid_block_s')}")
    return dict(results=results, launches=att.launch_counts["attention_fwd"],
                sampler_calls=len(rec.samples))

class LaunchShapes:
    """Tallies the attention kernels' launches by shape while entered, by
    wrapping the wrapper's launch functions (which keep their own counts):
    the forward's (both instances) by (B, N, h, d) in `fwd`, the
    backward's in `bwd`."""

    LAUNCHERS = ("_launch", "attention_forward_lse", "attention_backward")

    def __init__(self, att):
        import collections

        self.att = att
        self.real = {name: getattr(att, name) for name in self.LAUNCHERS}
        self.fwd = collections.Counter()
        self.bwd = collections.Counter()

    def __enter__(self):
        def wrap(name, real):
            def launch(q, *args):
                out = real(q, *args)
                if name == "attention_backward":
                    self.bwd[tuple(q.shape)] += 1
                else:
                    self.fwd[tuple(q.shape)] += 1
                return out

            return launch

        for name, real in self.real.items():
            setattr(self.att, name, wrap(name, real))
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.att, name, real)

    def fwd_by_n_d(self) -> dict:
        """{(N, d): launches} of the forward."""
        counts: dict = {}
        for (_, n, _, d), c in self.fwd.items():
            counts[n, d] = counts.get((n, d), 0) + c
        return counts

    @staticmethod
    def named(counter) -> dict:
        """{"B8 N1024 h4 d32": launches} of a (B, N, h, d) counter."""
        return {f"B{b} N{n} h{h} d{d}": c for (b, n, h, d), c in
                counter.items()}


def phase_http(att, torch, np, Enhancer, flagship_config) -> dict:
    """serve_http on 127.0.0.1 (port 0) over a flagship Enhancer (bf16,
    DPM++2M-5, max_batch 1): three POST /enhance (256², 300×200, and 256²
    with ?size=128x96), GET /healthz and /stats, a bad body; returns each
    request's latency."""
    import urllib.error
    import urllib.request

    from hybrid_diffusion_tpu_torch import serve_http
    from hybrid_diffusion_tpu_torch.data.registry import _png_bytes, _png_decode

    enh = Enhancer(flagship_config(), FLAGSHIP_NPZ, max_batch=1, device="cuda")
    server = serve_http.serve(enh, host="127.0.0.1", port=0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(5)
    cases = [("", (256, 256), (256, 256)), ("", (200, 300), (200, 300)),
             ("?size=128x96", (256, 256), (96, 128))]
    latencies = []
    try:
        att.reset_launch_count()
        for query, (h, w), want in cases:
            body = _png_bytes(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            req = urllib.request.Request(f"{base}/enhance{query}", data=body,
                                         method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                status, data = r.status, r.read()
            latencies.append((time.perf_counter() - t0) * 1e3)
            out = _png_decode(data)
            if status != 200 or out is None or out.shape[:2] != want:
                fail(f"POST /enhance{query} of a {h}x{w} PNG gave status "
                     f"{status} and {None if out is None else out.shape}, "
                     f"expected {want}")
        if att.launch_counts["attention_fwd"] != 20 * len(cases) \
                or att.launch_count != 20 * len(cases):
            fail(f"{len(cases)} requests launched the kernels "
                 f"{att.launch_counts}, expected the bf16 kernel 20 times each")
        req = urllib.request.Request(f"{base}/enhance", data=b"not an image",
                                     method="POST")
        try:
            urllib.request.urlopen(req, timeout=30)
            fail("a bad body got a 2xx")
        except urllib.error.HTTPError as e:
            if not 400 <= e.code < 500:
                fail(f"a bad body got HTTP {e.code}, expected a 4xx")
            bad_code = e.code
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        if health != {"status": "ok", "requests": len(cases)} \
                or stats["errors"] != 1:
            fail(f"/healthz {health}, /stats {stats}")
    finally:
        server.shutdown()
        server.server_close()
    del enh
    return dict(latency_ms=latencies, bad_body_code=bad_code, stats=stats)


def phase_export(att, torch, np, enh, batch_u8) -> dict:
    """export_enhancer of the flagship Enhancer, load_exported, and the
    loaded program against the Enhancer on the same noise; returns the
    times, the artifact's size and the difference."""
    from hybrid_diffusion_tpu_torch.serve import export_enhancer, load_exported

    t0 = time.perf_counter()
    data = export_enhancer(enh)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = load_exported(data)
    load_s = time.perf_counter() - t0
    x = torch.from_numpy(batch_u8).cuda()
    att.reset_launch_count()
    out = run(x, torch.Generator("cuda").manual_seed(7))
    torch.cuda.synchronize()
    counts = {k: n for k, n in att.launch_counts.items() if n}
    if counts != {"attention_fwd": 20}:
        fail(f"one call of the exported program launched {counts}, expected "
             f"the bf16 kernel 20 times and no other")
    noise = torch.randn(x.shape, generator=torch.Generator("cuda").manual_seed(7),
                        device="cuda")
    want = enh._sample(x, None, noise)
    diff = (out.int() - want.int()).abs()
    max_diff, n_diff = int(diff.max()), int((diff > 0).sum())
    if out.dtype != torch.uint8 or out.shape != want.shape \
            or max_diff > EXPORT_MAX_LEVELS:
        fail(f"the exported program gave {out.dtype} {tuple(out.shape)}, "
             f"{n_diff} bytes off the Enhancer's by up to {max_diff} levels "
             f"(limit {EXPORT_MAX_LEVELS})")
    timings = {}
    for name, fn in (("exported", lambda: run(x)),
                     ("enhancer", lambda: enh._sample(x, None, noise))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        timings[name] = (time.perf_counter() - t0) / 3 * 1e3
    return dict(export_s=export_s, load_s=load_s, mib=len(data) / 2**20,
                max_diff=max_diff, bytes_diff=n_diff,
                exported_call_ms=timings["exported"],
                enhancer_call_ms=timings["enhancer"])


def phase_cfg(att, torch, np, tmp: Path) -> dict:
    """train_cfg at CFGConfig() for CFG_TRAIN_STEPS steps, evaluate_cfg from
    its checkpoint over the whole T = 500 chain at w 1.8 on the 10 × 8 label
    grid (500 calls of 2B = 160), and the fp32 forward card against CPU;
    returns the phase's record."""
    import dataclasses as dc

    from hybrid_diffusion_tpu_torch.cfg import train as cfg_train
    from hybrid_diffusion_tpu_torch.train.checkpoint import restore_params

    config = cfg_train.CFGConfig(save_dir=str(tmp / "cfg_ck"),
                                 sampled_dir=str(tmp / "cfg_out"),
                                 device="cuda")
    steps, calls = [], []
    real_step, real_sample = (cfg_train.make_cfg_train_step,
                              cfg_train.cfg_ddpm_sample)

    def make_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def timed(state, batch, generator):
            torch.cuda.synchronize()
            before = dict(att.launch_counts)
            t0 = time.perf_counter()
            state, metrics = step(state, batch, generator)
            loss = float(metrics["loss"])
            steps.append(dict(
                ms=(time.perf_counter() - t0) * 1e3, loss=loss,
                launches={k: n - before[k] for k, n in
                          att.launch_counts.items() if n != before[k]}))
            return state, metrics

        return timed

    def sample(denoise_fn, *args, **kwargs):
        def counted(x, t, labels):
            before = att.launch_count
            out = denoise_fn(x, t, labels)
            calls.append((x.shape[0], att.launch_count - before))
            return out

        return real_sample(counted, *args, **kwargs)

    cfg_train.make_cfg_train_step, cfg_train.cfg_ddpm_sample = make_step, sample
    try:
        torch.cuda.reset_peak_memory_stats()
        with LaunchShapes(att) as train_shapes:
            summary = cfg_train.train_cfg(config, max_steps=CFG_TRAIN_STEPS)
        train_gib = torch.cuda.max_memory_allocated() / 2**30
        ckpt = summary["checkpoints"][-1]
        del summary
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        att.reset_launch_count()
        with LaunchShapes(att) as shapes:
            t0 = time.perf_counter()
            imgs = cfg_train.evaluate_cfg(config, checkpoint_path=ckpt)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
        eval_gib = torch.cuda.max_memory_allocated() / 2**30
        eval_launches = att.launch_counts["attention_fwd"]
        other = att.launch_count - eval_launches
    finally:
        cfg_train.make_cfg_train_step = real_step
        cfg_train.cfg_ddpm_sample = real_sample
    step_launches = {"attention_fwd": 21, "attention_bwd": 21}
    if len(steps) != CFG_TRAIN_STEPS or any(
            st["launches"] != step_launches or not math.isfinite(st["loss"])
            for st in steps):
        fail(f"train_cfg steps {steps}: expected {CFG_TRAIN_STEPS} finite "
             f"steps of {step_launches} launches")
    want = {case[:4]: CFG_TRAIN_STEPS * CFG_SHAPES[case[1], case[3]]
            for case in CFG_TRAIN_CASES}
    if dict(train_shapes.fwd) != want or dict(train_shapes.bwd) != want:
        fail(f"train_cfg launched the forward by shape "
             f"{dict(train_shapes.fwd)} and the backward by shape "
             f"{dict(train_shapes.bwd)}, expected each {want}")
    n_img = config.num_labels * config.nrow
    if len(calls) != config.T or any(c != (CFG_BATCH, 21) for c in calls):
        fail(f"evaluate_cfg made {len(calls)} model calls with (batch, "
             f"launches) {sorted(set(calls))}, expected {config.T} of "
             f"({CFG_BATCH}, 21)")
    by_n_d = shapes.fwd_by_n_d()
    per_call = {f"N{n} d{d}": by_n_d.get((n, d), 0) / len(calls)
                for n, d in CFG_SHAPES}
    if other or by_n_d != {k: v * len(calls) for k, v in CFG_SHAPES.items()}:
        fail(f"evaluate_cfg launched the kernels by shape {by_n_d}"
             f" ({other} launches of another kernel), expected per call "
             f"{CFG_SHAPES}")
    if imgs.shape != (n_img, 32, 32, 3) or imgs.dtype != np.uint8 \
            or int(np.ptp(imgs)) == 0:
        fail(f"evaluate_cfg gave {imgs.shape} {imgs.dtype} with range "
             f"{np.ptp(imgs)}")
    if not (tmp / "cfg_out" / "SampledGuidenceImgs.png").is_file():
        fail("evaluate_cfg wrote no PNG grid")

    # The fp32 forward on the card against the CPU's, on the trained weights.
    fp32 = dc.replace(config, bf16=False, dropout=0.0)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, config.T, (4,)))
    labels = torch.tensor([0, 1, 5, 10])
    outs = {}
    for device, nudge in (("cuda", False), ("cpu", False), ("cpu", True)):
        model = restore_params(ckpt, cfg_train.build_cfg_model(fp32)).eval()
        if nudge:
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(torch.from_numpy(1 + 2.0 ** -23 * rng.choice(
                        [-1.0, 1.0], tuple(p.shape))).float())
        model = model.to(device)
        with torch.no_grad():
            outs[device, nudge] = model(x.to(device), t.to(device),
                                        labels.to(device)).double().cpu()
    cpu = outs["cpu", False]
    scale = float(cpu.abs().max())
    fwd_rel = float((outs["cuda", False] - cpu).abs().max()) / scale
    kappa = float((outs["cpu", True] - cpu).abs().max()) / scale
    bound = max(CFG_FWD_FLOOR, 10 * kappa)
    if not math.isfinite(fwd_rel) or fwd_rel > bound:
        fail(f"card fp32 CFGUNet forward vs CPU: {fwd_rel} of max|out| > "
             f"{bound} (κ {kappa})")
    return dict(train_step_ms=[st["ms"] for st in steps],
                train_losses=[st["loss"] for st in steps],
                train_peak_gib=train_gib, eval_s=eval_s,
                images_per_s=n_img / eval_s, eval_calls=len(calls),
                eval_peak_gib=eval_gib, launches=eval_launches,
                launches_per_call=per_call,
                launches_by_shape={f"N{n} d{d}": c
                                   for (n, d), c in by_n_d.items()},
                train_bwd_launches_by_shape=LaunchShapes.named(
                    train_shapes.bwd),
                fp32_fwd_rel=fwd_rel, fp32_fwd_bound=bound, kappa=kappa)


def phase_ddpm(att, torch, np) -> dict:
    """The flagship npz at 64², batch 2, fp32, through make_sampler's ddpm
    branch over the full T = 1000 chain; and one step (t = 999) on injected
    noise, card against CPU; returns the phase's record."""
    from hybrid_diffusion_tpu_torch.config import flagship_config
    from hybrid_diffusion_tpu_torch.diffusion import (
        ddpm_step, linear_beta_schedule)
    from hybrid_diffusion_tpu_torch.train.loop import build_model, make_sampler
    from hybrid_diffusion_tpu_torch.train.step import normalize_uint8
    from hybrid_diffusion_tpu_torch.weights import load_npz_state_dict

    cfg = dataclasses.replace(flagship_config(img_size=64, bf16=False),
                              ddim=False, sampler="")
    state = load_npz_state_dict(FLAGSHIP_NPZ)
    models = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg)
        model.load_state_dict(state, strict=True)
        models[device] = model.to(device).eval()
    rng = np.random.default_rng(12)
    cond = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    att.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = make_sampler(cfg, models["cuda"])(
        torch.from_numpy(cond).cuda(), torch.Generator("cuda").manual_seed(3))
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    counts = {k: n for k, n in att.launch_counts.items() if n}
    if counts != {"attention_fwd_fp32": 4 * cfg.T}:
        fail(f"the ddpm chain launched {counts}, expected the fp32 kernel "
             f"{4 * cfg.T} times (4 a step)")
    out = out.cpu().numpy()
    if out.shape != (2, 64, 64, 3) or not np.isfinite(out).all() \
            or out.min() < 0 or out.max() > 1 or out.std() == 0:
        fail(f"the ddpm chain gave {out.shape}, range [{out.min()}, "
             f"{out.max()}], std {out.std()}")

    schedule = linear_beta_schedule(cfg.beta_1, cfg.beta_T, cfg.T)
    y = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    z = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    step, eps = {}, {}
    for device, model in models.items():
        c = normalize_uint8(torch.from_numpy(cond).to(device))
        yt = torch.from_numpy(y).to(device)
        with torch.no_grad():
            e = model(torch.cat([c, yt], dim=-1),
                      torch.full((2,), cfg.T - 1, device=device))
            step[device] = ddpm_step(schedule, yt, cfg.T - 1, e,
                                     torch.from_numpy(z).to(device)
                                     ).double().cpu()
        eps[device] = e.double().cpu()
    step_rel = float((step["cuda"] - step["cpu"]).abs().max()
                     / step["cpu"].abs().max())
    eps_rel = float((eps["cuda"] - eps["cpu"]).abs().max()
                    / eps["cpu"].abs().max())
    if not math.isfinite(step_rel) or step_rel > DDPM_STEP_RTOL:
        fail(f"one ddpm step card vs CPU: rel {step_rel} > {DDPM_STEP_RTOL} "
             f"(ε rel {eps_rel})")
    return dict(chain_s=chain_s, steps=cfg.T, ms_per_step=chain_s / cfg.T * 1e3,
                launches=counts["attention_fwd_fp32"], step_rel=step_rel,
                eps_rel=eps_rel, out_mean=float(out.mean()),
                out_std=float(out.std()))


def phase_vgg(att, torch, np) -> dict:
    """VGG_STEPS flagship-width bf16 steps (batch 16) under the run-book's
    stage-1 loss set with vgg16 at random init; returns the phase's record."""
    import statistics

    from hybrid_diffusion_tpu_torch.config import flagship_config
    from hybrid_diffusion_tpu_torch.diffusion import linear_beta_schedule
    from hybrid_diffusion_tpu_torch.profile_train import (
        FINE_TUNE, synthetic_batches)
    from hybrid_diffusion_tpu_torch.train.loop import (
        _make_vgg, create_train_state, init_params)
    from hybrid_diffusion_tpu_torch.train.step import make_train_step

    cfg = flagship_config(**FINE_TUNE, stage1_losses=STAGE1_LOSSES)
    loss_cfg = cfg.stage_loss_config(0)
    if not (loss_cfg.vgg_weight and loss_cfg.charbonnier_weight) or \
            loss_cfg.dino_weight or loss_cfg.ms_ssim_weight \
            or loss_cfg.color_weight:
        fail(f"--stage1_losses {STAGE1_LOSSES!r} parsed to {loss_cfg}")
    model = init_params(cfg, "cuda")
    state = create_train_state(cfg, model, steps_per_epoch=100)
    vgg = _make_vgg(cfg, [loss_cfg], "cuda")
    step = make_train_step(
        linear_beta_schedule(cfg.beta_1, cfg.beta_T, cfg.T), loss_cfg,
        vgg_loss_fn=vgg, use_conditioning=cfg.use_conditioning,
        p_uncond=cfg.p_uncond, domain_routing=cfg.domain_routing)
    gen = torch.Generator("cuda").manual_seed(cfg.seed)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b in synthetic_batches(VGG_STEPS, cfg.batch_size,
                                          cfg.img_size)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds, losses, bwd_launches = [], [], 0
    for i, batch in enumerate(batches):
        att.reset_launch_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        values = {k: float(v) for k, v in metrics.items()}
        counts = {k: n for k, n in att.launch_counts.items() if n}
        if counts != TRAIN_STEP_LAUNCHES or "vgg" not in values \
                or "dino" in values \
                or not all(math.isfinite(v) for v in values.values()):
            fail(f"vgg step {i}: launches {counts}, metrics {values}")
        bwd_launches += counts["attention_bwd"]
        losses.append(values)
    return dict(steps=len(batches), step_ms=[x * 1e3 for x in seconds],
                median_step_ms=statistics.median(seconds[1:]) * 1e3,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                losses=losses, bwd_launches=bwd_launches)


# ---------------------------------------------------------------- parallel
# The parallel phase runs in spawned processes: the smoke's own process
# holds no process group. The card's machine has one H100, and NCCL refuses
# two ranks on one device, so the layer is driven in two parts: one rank
# over NCCL (the backend of multi-GPU runs) through train() and evaluate()
# (phase_world1, in the tools phase beside the tools), and two ranks over
# gloo on cuda:0 for the DDP, TP and ZeRO-1 steps and the sharded sampler,
# each held against one process (phase_parallel). Two ranks sharing one
# card say nothing about scaling: their times are printed, not compared.
#
# Gloo's point-to-point send/recv does not take CUDA tensors (a probe on the
# H100 got "writev ... Bad address"); ring attention's K/V rotation is made
# of them. So the ring runs on the card at world 1 over NCCL (its math, and
# one send/recv of NCCL's to itself), and at world 2 and 4 only on the CPU
# (tests/test_torch_ring_attention.py). Every other collective of the
# parallel layer (all_reduce, broadcast, barrier, DDP's) runs here on CUDA.
GLOO_REFUSED_ON_CUDA = ("batch_isend_irecv (ring attention's K/V rotation)",)
PAR_TIMEOUT_S = 110.0
# The gloo ranks' steps and the cases they hold against one process.
PAR_BATCH = 16            # DDP and ZeRO-1: global batch, 8 a rank
PAR_TP_BATCH = 8          # TP: each rank holds the whole batch
PAR_FP32_SIZE, PAR_FP32_BATCH = 64, 4
# The fp32 comparisons at 64², each against one process and κ, each
# case's seconds on rank 0 printed: DDP, TP (the head-sharded attention,
# its fp32 forward and backward kernels on 4 heads) and ZeRO-1 (the
# data-parallel mesh's gradient reduction with the sharded optimizer).
PAR_FP32_CASES = (("ddp", "2x1", False), ("tp", "1x2", False),
                  ("zero1", "2x1", True))
# bf16: two ranks' batches of 8 run other cuDNN algorithms and sum the loss
# and the gradients in another order than one batch of 16; bf16 keeps 8
# bits, so each such difference is a few units of 2^-9 in the terms. The
# bound on the loss and the gradient norm, relative: 2^-7.
PAR_BF16_RTOL = 2.0 ** -7
# The sharded sampler (DPM++2M-5, 8 images, fp32, 64²) against one process:
# its rows run at batch 4 instead of 8, other cuDNN algorithms summing in
# another order; a uint8 value may cross a quantization step. At most one
# level, on at most PAR_SAMPLE_MAX_SHARE of the bytes.
PAR_SAMPLE_MAX_SHARE = 1e-3
PAR_SAMPLER_IMAGES = 8


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _par_child(fn, rank, workdir, *args) -> None:
    """A spawned child: fn(rank, workdir, *args) -> dict, written as JSON;
    a traceback file and a non-zero exit on failure."""
    import traceback

    sys.path.insert(0, str(ROOT))
    try:
        out = fn(rank, workdir, *args)
    except BaseException:
        Path(workdir, f"error.{rank}.txt").write_text(traceback.format_exc())
        raise
    Path(workdir, f"result.{rank}.json").write_text(json.dumps(out))


def _par_spawn(fn, world: int, workdir: Path, *args) -> list:
    """Run fn on `world` spawned processes; fails the run when one exits
    non-zero or outlives PAR_TIMEOUT_S; returns their results."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_par_child,
                         args=(fn, r, str(workdir)) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + PAR_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.perf_counter(), 0.1))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        errors = "".join(
            f"\n--- rank {r}:\n" + (workdir / f"error.{r}.txt").read_text()
            for r in range(world) if (workdir / f"error.{r}.txt").exists())
        fail(f"parallel phase: {fn.__name__} ranks exited with {codes}"
             + (" (timed out)" if hung else "") + errors)
    return [json.loads((workdir / f"result.{r}.json").read_text())
            for r in range(world)]


def _par_world1(rank, workdir, argv, steps):
    """World 1 over NCCL on cuda:0: cli train with --zero1 for `steps`
    steps, a resume from its checkpoint with --mesh_data 1 --mesh_model 1,
    evaluate() of the resumed run's final checkpoint; ring attention and
    one NCCL send/recv at world 1. Returns the run's record."""
    import os

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    import torch
    import torch.distributed as dist

    from hybrid_diffusion_tpu_torch import cli
    from hybrid_diffusion_tpu_torch.config import parse_config
    from hybrid_diffusion_tpu_torch.ops import attention as att
    from hybrid_diffusion_tpu_torch.ops import ring_attention as ring
    from hybrid_diffusion_tpu_torch.parallel import make_mesh
    from hybrid_diffusion_tpu_torch.train import loop
    from hybrid_diffusion_tpu_torch.train.checkpoint import load_metadata

    set_tf32(torch, (False, False))
    tmp = Path(workdir)
    t0 = time.perf_counter()
    att.reset_launch_count()
    if cli.main(argv + ["--zero1"]) != 0:
        raise RuntimeError("cli train --zero1 returned non-zero")
    train_s = time.perf_counter() - t0
    launches = att.launch_counts["attention_fwd"]
    bwd_launches = att.launch_counts["attention_bwd"]
    if not dist.is_initialized() or "nccl" not in str(dist.get_backend()):
        raise RuntimeError("train() ran without an NCCL process group")
    ckpts = sorted((tmp / "ck").iterdir())
    periodic = [p for p in ckpts if "_final_" not in p.name]
    if len(periodic) != 1 or load_metadata(periodic[0])["step"] != steps:
        raise RuntimeError(f"checkpoints {[p.name for p in ckpts]}")
    # Resume from the periodic checkpoint (written by the ZeRO-1 run) with
    # the plain 1×1 mesh, two more steps.
    resume = parse_config(argv + ["--mesh_data", "1", "--mesh_model", "1",
                                  "--epochs_stage_1", "2", "--resume_from",
                                  str(periodic[0])])
    summary = loop.train(resume, max_steps=steps + 2)
    state = summary["state"]
    if state.step != steps + 2 or summary["steps"] != steps + 2:
        raise RuntimeError(f"the resume ran to step {state.step}, expected "
                           f"{steps + 2}")
    test = parse_config([a if a != "train" else "test" for a in argv]
                        + ["--pretrained_path",
                           summary["stages"][-1]["checkpoint"]])
    t1 = time.perf_counter()
    results = loop.evaluate(test, compute_fid=False, save_images=False)
    eval_s = time.perf_counter() - t1
    for domain, res in results.items():
        if not (res["n_images"] > 0 and all(
                math.isfinite(res[k]) for k in ("psnr", "ssim", "uiqm"))):
            raise RuntimeError(f"evaluate() {domain}: {res}")
    # Ring attention at world 1 on the card (forward and gradients against
    # the plain version), and its rotation's send/recv over NCCL to itself.
    mesh = make_mesh(1, 1)
    g = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 1024, 8, 32, device="cuda", generator=g)
               .requires_grad_() for _ in range(3))
    out = ring.ring_spatial_attention(q, k, v, mesh)
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    ref = att.attention_reference(q, k, v)
    ref_grads = torch.autograd.grad(ref.sum(), (q, k, v))
    ring_err = max(float((a - b).detach().abs().max())
                   for a, b in zip((out,) + grads, (ref,) + ref_grads))
    if ring_err > 1e-4:
        raise RuntimeError(f"ring attention at world 1 differs by {ring_err}")
    sent = torch.arange(8.0, device="cuda")
    (got,), reqs = ring._rotate([sent], dist.group.WORLD)
    ring._wait(reqs)
    if not torch.equal(got, sent):
        raise RuntimeError("NCCL send/recv to self lost the tensor")
    dist.destroy_process_group()
    return dict(train_s=train_s, launches=launches,
                bwd_launches=bwd_launches, eval_s=eval_s,
                resumed_to=state.step, ring_err=ring_err,
                results={d: {k: r[k] for k in ("psnr", "ssim", "n_images")}
                         for d, r in results.items()},
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _par_rank(rank, workdir):
    """One of two gloo ranks on cuda:0: DDP (2×1), TP (1×2) and ZeRO-1
    (2×1) steps at the flagship width in bf16, TP and ZeRO-1 in fp32 at 64²,
    and the sharded sampler; rank 0 also runs each against one process."""
    import copy
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from hybrid_diffusion_tpu_torch.config import flagship_config
    from hybrid_diffusion_tpu_torch.diffusion import linear_beta_schedule
    from hybrid_diffusion_tpu_torch.ops import attention as att
    from hybrid_diffusion_tpu_torch.parallel import (
        make_mesh, shard_batch, shard_params, shard_state)
    from hybrid_diffusion_tpu_torch.parallel.sharding import (
        full_state_payload)
    from hybrid_diffusion_tpu_torch.profile_train import synthetic_batches
    from hybrid_diffusion_tpu_torch.train.loop import (
        create_train_state, init_params, make_dino, make_sampler)
    from hybrid_diffusion_tpu_torch.train.step import make_train_step

    set_tf32(torch, (False, False))
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    dist.init_process_group("gloo", init_method=f"file://{workdir}/pg",
                            rank=rank, world_size=2)
    meshes = {"2x1": make_mesh(2, 1), "1x2": make_mesh(1, 2)}
    main = rank == 0
    built = {}

    def model_of(cfg):
        """init_params(cfg) on the card, and make_dino(cfg): each config's
        weights (drawn from cfg.seed, then the npz) are made once a process
        and copied for each run, which changes them; the DINO extractor is
        frozen and shared (rank 0 sets up ten runs)."""
        if id(cfg) not in built:
            built[id(cfg)] = (init_params(cfg, "cpu"), make_dino(cfg, "cuda"))
        model, dino = built[id(cfg)]
        return copy.deepcopy(model).to("cuda"), dino

    def run(cfg, mesh, zero1, batch, t, noise, steps=1, grads=False,
            nudge=None):
        """steps of the step on `mesh` (None: one process) from the npz's
        weights (each moved by one ulp, ×(1 ± 2⁻²³), signs from the numpy
        generator `nudge`); the first step's metrics, each step's ms, and
        (grads) the first update's whole gradients, AdamW's first moment
        over 0.1, flattened in name order."""
        model, dino = model_of(cfg)
        if nudge is not None:
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(torch.from_numpy(1 + 2.0 ** -23 * nudge.choice(
                        [-1.0, 1.0], tuple(p.shape))).float().cuda())
        if mesh is not None:
            shard_params(mesh, model)
        state = create_train_state(cfg, model, steps_per_epoch=100)
        if mesh is not None:
            shard_state(mesh, state, zero1=zero1)
        step = make_train_step(
            linear_beta_schedule(cfg.beta_1, cfg.beta_T, cfg.T),
            cfg.loss_config, dino_loss_fn=dino, domain_routing=True,
            mesh=mesh)
        local = (batch if mesh is None else shard_batch(mesh, batch))
        gen = torch.Generator("cuda").manual_seed(cfg.seed)
        first, ms = None, []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, local, gen, t=t, noise=noise)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if first is None:
                first = {k: float(v) for k, v in metrics.items()}
                if grads:
                    if mesh is None:
                        mu = {n: state.moments(n)["exp_avg"]
                              for n in state.params}
                    else:
                        payload = full_state_payload(state)
                        names = list(state.params)
                        mu = {names[i]: s["exp_avg"] for i, s in
                              payload["optimizer"]["state"].items()}
                    first["grad"] = torch.cat([
                        (mu[n].double() / 0.1).flatten().cpu()
                        for n in sorted(mu)])
        del state, step
        torch.cuda.empty_cache()
        return first, ms

    flag = flagship_config(init_from_npz=str(FLAGSHIP_NPZ), dropout=0.0,
                           lr=1e-5)
    rng = np.random.default_rng(11)
    bf16 = {}
    for case, mesh_name, zero1, B in (("ddp", "2x1", False, PAR_BATCH),
                                      ("tp", "1x2", False, PAR_TP_BATCH),
                                      ("zero1", "2x1", True, PAR_BATCH)):
        batch = {k: torch.from_numpy(v).cuda() for k, v in
                 synthetic_batches(1, B, flag.img_size, seed=5)[0].items()}
        t = torch.from_numpy(rng.integers(0, flag.T, (B,))).cuda()
        noise = torch.from_numpy(rng.standard_normal(
            (B, flag.img_size, flag.img_size, 3)).astype(np.float32)).cuda()
        torch.cuda.reset_peak_memory_stats()
        att.reset_launch_count()
        with LaunchShapes(att) as shapes:
            got, ms = run(flag, meshes[mesh_name], zero1, batch, t, noise,
                          steps=2)
        rec = dict(metrics=got, step_ms=ms,
                   launches=LaunchShapes.named(shapes.fwd),
                   bwd_launches=LaunchShapes.named(shapes.bwd),
                   launch_count=att.launch_counts["attention_fwd"],
                   bwd_launch_count=att.launch_counts["attention_bwd"],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        dist.barrier()
        if main:      # one process on the same global batch, t and noise
            want, _ = run(flag, None, False, batch, t, noise)
            rec["one_process"] = want
            rec["loss_rel"] = abs(got["total"] - want["total"]) / abs(
                want["total"])
            rec["grad_norm_rel"] = abs(got["grad_norm"] - want["grad_norm"]
                                       ) / want["grad_norm"]
        dist.barrier()
        bf16[case] = rec

    # fp32 at 64²: each case's first update against one process, and κ,
    # one process's own change when every weight moves by one ulp.
    cfg64 = flagship_config(init_from_npz=str(FLAGSHIP_NPZ), dropout=0.0,
                            lr=1e-5, img_size=PAR_FP32_SIZE, bf16=False)
    B = PAR_FP32_BATCH
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batches(
        1, B, PAR_FP32_SIZE, seed=6)[0].items()}
    t = torch.from_numpy(rng.integers(0, cfg64.T, (B,))).cuda()
    noise = torch.from_numpy(rng.standard_normal(
        (B, PAR_FP32_SIZE, PAR_FP32_SIZE, 3)).astype(np.float32)).cuda()
    fp32, fp32_launches = {}, {}

    def counted(name, *args, **kwargs):
        """run(*args), its attention launches by kernel in fp32_launches."""
        att.reset_launch_count()
        got = run(*args, **kwargs)
        fp32_launches[name] = {k: n for k, n in att.launch_counts.items() if n}
        return got

    seconds = {}
    for case, mesh_name, zero1 in PAR_FP32_CASES:
        t0 = time.perf_counter()
        got, _ = counted(case, cfg64, meshes[mesh_name], zero1, batch, t,
                         noise, grads=True)
        seconds[case] = time.perf_counter() - t0
        fp32[case] = got
    fp32_rec = {}
    if main:
        want, _ = counted("one", cfg64, None, False, batch, t, noise,
                          grads=True)
        ulp, _ = counted("one_ulp", cfg64, None, False, batch, t, noise,
                         grads=True, nudge=np.random.default_rng(12))
        g0 = want["grad"]
        kappa = float((ulp["grad"] - g0).norm() / g0.norm())
        for case, got in fp32.items():
            fp32_rec[case] = dict(
                loss_rel=abs(got["total"] - want["total"]) / abs(
                    want["total"]),
                grad_rel=float((got["grad"] - g0).norm() / g0.norm()))
        fp32_rec["kappa"] = kappa
        fp32_rec["grad_bound"] = max(TRAIN_GRAD_FLOOR, 10 * kappa)
        fp32_rec["seconds"] = seconds
    dist.barrier()

    # The sharded sampler: DPM++2M-5, 8 images, fp32 at 64², 2×1.
    cfg_s = flagship_config(img_size=PAR_FP32_SIZE, bf16=False, dropout=0.0,
                            init_from_npz=str(FLAGSHIP_NPZ))
    model = init_params(cfg_s, "cuda").eval()
    cond = torch.from_numpy(np.random.default_rng(13).integers(
        0, 256, (PAR_SAMPLER_IMAGES, PAR_FP32_SIZE, PAR_FP32_SIZE, 3),
        dtype=np.uint8)).cuda()
    sharded = make_sampler(cfg_s, model, quantize_uint8=True,
                           mesh=meshes["2x1"])(
        cond, torch.Generator("cuda").manual_seed(3)).cpu().numpy()
    sample_rec = {}
    if main:
        one = make_sampler(cfg_s, model, quantize_uint8=True)(
            cond, torch.Generator("cuda").manual_seed(3)).cpu().numpy()
        diff = np.abs(sharded.astype(int) - one.astype(int))
        sample_rec = dict(max_levels=int(diff.max()),
                          share=float((diff > 0).mean()),
                          shape=list(sharded.shape))
    dist.barrier()
    dist.destroy_process_group()
    return dict(bf16=bf16, fp32=fp32_rec, fp32_launches=fp32_launches,
                sampler=sample_rec,
                step_ms_median={c: statistics.median(r["step_ms"][1:])
                                for c, r in bf16.items()})


def phase_world1(tmp: Path) -> dict:
    """The parallel layer's NCCL part (see the comment above
    GLOO_REFUSED_ON_CUDA), one spawned rank on cuda:0; fails the run on a
    wrong launch count. Runs beside the tools' chains (phase_tools)."""
    from hybrid_diffusion_tpu_torch.data.datasets import make_dataset

    length = 32
    argv = ["--state", "train", "--device", "cuda", "--synthetic_data",
            "--synthetic_length", str(length), "--img_size", "256",
            "--batch_size", str(PAR_BATCH), "--bf16", "--lr", "1e-5",
            "--init_from_npz", str(FLAGSHIP_NPZ), "--epochs_stage_1", "1",
            "--epochs_stage_2", "0", "--save_checkpoint", "1",
            "--sampler", "dpm++2m", "--ddim_step", "5", "--ema_decay", "0.99",
            "--checkpoint_dir", str(tmp / "w1" / "ck"),
            "--output_path", str(tmp / "w1" / "out")]
    steps = len(make_dataset("synthetic-underwater", "train",
                             synthetic_length=length)) // PAR_BATCH
    (tmp / "w1").mkdir()
    t0 = time.perf_counter()
    w1 = _par_spawn(_par_world1, 1, tmp / "w1", argv, steps)[0]
    w1["seconds"] = time.perf_counter() - t0
    if w1["launches"] != 4 * steps or w1["bwd_launches"] != 4 * steps:
        fail(f"world-1 NCCL train launched the forward {w1['launches']} and "
             f"the backward {w1['bwd_launches']} times in {steps} steps, "
             f"expected 4 each a step")
    return {"world1": w1}


def phase_parallel(torch, np, tmp: Path) -> dict:
    """The parallel layer's gloo part on the card (see the comment above
    GLOO_REFUSED_ON_CUDA); fails the run on any disagreement."""
    (tmp / "gloo").mkdir()
    t0 = time.perf_counter()
    ranks = _par_spawn(_par_rank, 2, tmp / "gloo")
    seconds = time.perf_counter() - t0
    r0 = ranks[0]
    for case, rec in r0["bf16"].items():
        if not (rec["loss_rel"] <= PAR_BF16_RTOL
                and rec["grad_norm_rel"] <= PAR_BF16_RTOL):
            fail(f"{case} bf16 step: loss rel {rec['loss_rel']}, grad norm "
                 f"rel {rec['grad_norm_rel']} against one process, bound "
                 f"{PAR_BF16_RTOL}")
    for case, _, _ in PAR_FP32_CASES:
        rec = r0["fp32"][case]
        if not (rec["loss_rel"] <= TRAIN_LOSS_RTOL
                and rec["grad_rel"] <= r0["fp32"]["grad_bound"]):
            fail(f"{case} fp32 step at 64²: loss rel {rec['loss_rel']} "
                 f"(bound {TRAIN_LOSS_RTOL}), gradients rel "
                 f"{rec['grad_rel']} (bound {r0['fp32']['grad_bound']})")
    for rank in ranks:
        for case, rec in rank["bf16"].items():
            if rec["launch_count"] != sum(rec["launches"].values()) or \
                    rec["bwd_launch_count"] != sum(rec["bwd_launches"].values()):
                fail(f"{case}: the wrapper counted {rec['launch_count']} "
                     f"forward and {rec['bwd_launch_count']} backward "
                     f"launches, the shapes {rec['launches']} and "
                     f"{rec['bwd_launches']}")
    tp_shape = f"B{PAR_TP_BATCH} N1024 h4 d32"
    tp_launches = sum(r["bf16"]["tp"]["launches"].get(tp_shape, 0)
                      for r in ranks)
    tp_bwd_launches = sum(r["bf16"]["tp"]["bwd_launches"].get(tp_shape, 0)
                          for r in ranks)
    # Two steps on each rank, 4 middle blocks: 8 launches a rank on 4 heads,
    # of the forward and of the backward.
    if any(r["bf16"]["tp"]["launches"] != {tp_shape: 8}
           or r["bf16"]["tp"]["bwd_launches"] != {tp_shape: 8}
           for r in ranks):
        fail(f"the TP steps launched the forward "
             f"{[r['bf16']['tp']['launches'] for r in ranks]} and the "
             f"backward {[r['bf16']['tp']['bwd_launches'] for r in ranks]}, "
             f"expected each on 4 heads ({tp_shape}) 8 times a rank")
    ddp_shape = f"B{PAR_BATCH // 2} N1024 h8 d32"
    for case in ("ddp", "zero1"):
        if any(r["bf16"][case]["launches"] != {ddp_shape: 8}
               or r["bf16"][case]["bwd_launches"] != {ddp_shape: 8}
               for r in ranks):
            fail(f"the {case} steps launched the forward "
                 f"{[r['bf16'][case]['launches'] for r in ranks]} and the "
                 f"backward {[r['bf16'][case]['bwd_launches'] for r in ranks]}"
                 f", expected each {{{ddp_shape!r}: 8}} a rank")
    # Each fp32 step (one a case and rank, and rank 0's two one-process
    # steps) runs the fp32 forward and backward kernels 4 times each.
    for r, rank in enumerate(ranks):
        for case, counts in rank["fp32_launches"].items():
            if counts != FP32_STEP_LAUNCHES:
                fail(f"rank {r}'s fp32 {case} step launched the attention "
                     f"kernels {counts}, expected {FP32_STEP_LAUNCHES}")
    fp32_bwd_launches = sum(c["attention_bwd_fp32"] for rank in ranks
                            for c in rank["fp32_launches"].values())
    sm = r0["sampler"]
    if sm["shape"] != [PAR_SAMPLER_IMAGES, PAR_FP32_SIZE, PAR_FP32_SIZE, 3] \
            or sm["max_levels"] > 1 or sm["share"] > PAR_SAMPLE_MAX_SHARE:
        fail(f"the sharded sampler against one process: {sm}")
    return dict(ranks=ranks, gloo_seconds=seconds,
                tp_launches=tp_launches, tp_bwd_launches=tp_bwd_launches,
                tp_shape=tp_shape, fp32_bwd_launches=fp32_bwd_launches)


# The tools phase: the port's bench and scripts, each a subprocess started
# as a user starts it (python -m ...), in a temporary directory with the
# checkout on PYTHONPATH.
TOOL_TIMEOUT_S = 240.0
# CPU threads of each tool that runs beside others (the card's machine has
# 8 cores, seven chains run at once).
TOOL_THREADS = 2
# The bench at the flagship width: DDIM-100 sampling at 256², batch 16,
# bf16 (BENCH_REPS timed runs after the bench's warm-up) and the train step
# at batch 16 (DINO off). Every U-Net call runs the 4 middle blocks'
# attention: 4 × 100 launches a sampling run.
BENCH_SAMPLE_REPS = 1
BENCH_TRAIN_REPS = 3
BENCH_DDIM_STEPS = 100
# eval_flagship at the committed operating point: the argv that
# flagship256_r5_dpm5_eval.json records (the r5 npz, DPM++2M-5, guidance
# 1.0, the synthetic val split at its default length 512: 73 images a
# domain, no --fid). Its PSNR and SSIM are printed beside the committed
# ones; the run fails if the port's PSNR is more than EVAL_PSNR_GAP_DB
# below them (the committed run sampled other noise with the JAX package).
COMMITTED_EVAL = ROOT / "flagship256_r5_dpm5_eval.json"
EVAL_PSNR_GAP_DB = 1.0
# rescore_metrics re-reads the images eval_flagship saved (lossless PNGs of
# the scored uint8 samples): the same mean PSNR, rounded to 3 places by
# eval_flagship and to 4 by rescore, so within RESCORE_PSNR_ATOL.
RESCORE_PSNR_ATOL = 1e-3
# The sweep's and the exported checkpoint's eval: the synthetic val split at
# length 14 (2 images a domain).
TOOLS_SHORT_LENGTH = 14
# The demos at a few steps, their evals cut to DDIM-10 (demo_staged's
# corpus to 64 pairs a domain); demo_cfg and regen_cfg_grids over a T 100
# chain (CFGConfig's T is 500) at two guidance scales, 2 rows. Cuts of
# depth, not of width.
_CFG_CUT = ["--T", "100", "--ws", "0,1.8", "--nrow", "2"]
DEMO_ARGV = {"demo_e2e": ["--steps", "4", "--size", "64",
                          "--ddim_steps", "10"],
             "demo_staged": ["--steps_per_stage", "2", "--ddim_steps", "10",
                             "--synthetic_length", "64"],
             "demo_cfg": ["--steps", "4"] + _CFG_CUT,
             "regen_cfg_grids": _CFG_CUT}


def _run_tool(name: str, argv: list, tmp: Path, env: dict | None = None,
              ok_codes=(0,), threads: int | None = None) -> dict:
    """`python -m hybrid_diffusion_tpu_torch.<argv...>` in `tmp`, the
    checkout on its path; fails the run on another exit code or after
    TOOL_TIMEOUT_S. `threads` caps its CPU threads (OMP_NUM_THREADS).
    Returns its exit code, stdout's JSON lines and `# record` lines, its
    `#` lines and its seconds."""
    import os
    import subprocess

    cmd = [sys.executable, "-m", "hybrid_diffusion_tpu_torch." + argv[0]]
    cmd += [str(a) for a in argv[1:]]
    path = os.pathsep.join([str(ROOT)] + [p for p in os.environ.get(
        "PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.perf_counter()
    try:
        # From tmp: what a tool writes to its default relative paths
        # (output/...) stays out of the checkout.
        proc = subprocess.run(cmd, cwd=tmp, capture_output=True, text=True,
                              timeout=TOOL_TIMEOUT_S,
                              env={**os.environ, "PYTHONPATH": path,
                                   **({"OMP_NUM_THREADS": str(threads)}
                                      if threads else {}),
                                   **(env or {})})
    except subprocess.TimeoutExpired:
        fail(f"tools: {name} ran past {TOOL_TIMEOUT_S:.0f}s: {' '.join(cmd)}")
    seconds = time.perf_counter() - t0
    (tmp / f"{name}.out").write_text(proc.stdout)
    (tmp / f"{name}.err").write_text(proc.stderr)
    # A tool's own verdict may be a non-zero code in ok_codes; an uncaught
    # exception (exit 1 too) never is.
    if proc.returncode not in ok_codes or "Traceback (most recent call last)" \
            in proc.stderr:
        fail(f"tools: {name} exited {proc.returncode}: {' '.join(cmd)}\n"
             f"{proc.stderr[-3000:]}")
    lines = []
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            try:
                lines.append(json.loads(line))
            except ValueError:
                pass        # the scripts' indented JSON starts with "{" alone
    notes = [ln for ln in proc.stderr.splitlines() if ln.startswith("#")]
    records = [json.loads(ln[len("# record "):]) for ln in notes
               if ln.startswith("# record ")]
    return dict(rc=proc.returncode, lines=lines, records=records,
                notes=notes, seconds=seconds)


def _bench_lines(run: dict, n: int, unit: str) -> list:
    """The bench's n result lines: each with the four keys and a finite
    positive value in `unit`."""
    lines = run["lines"]
    if len(lines) != n or any(
            set(ln) != {"metric", "value", "unit", "vs_baseline"}
            or ln["unit"] != unit or not math.isfinite(ln["value"])
            or ln["value"] <= 0 for ln in lines):
        fail(f"tools: the bench printed {lines}, expected {n} line(s) of "
             f"metric, value, unit ({unit}), vs_baseline, finite and > 0")
    return lines


def _finite_tree(obj) -> bool:
    if isinstance(obj, dict):
        return all(_finite_tree(v) for v in obj.values())
    if isinstance(obj, list):
        return all(_finite_tree(v) for v in obj)
    return not isinstance(obj, float) or math.isfinite(obj)


def phase_tools(np, tmp: Path, loop_ckpt: Path) -> dict:
    """The bench, eval_flagship, sweep_sampler, export_params, rescore,
    the preview grid and the four demos, each as its own process on the
    card, and beside them the world-1 NCCL rank (phase_world1); returns the
    phase's record."""
    rec = {}
    # ------------------------------------------------------------ bench
    run = _run_tool("bench_sample", ["bench"], tmp, env=dict(
        BENCH_REPS=str(BENCH_SAMPLE_REPS), BENCH_STEPS=str(BENCH_DDIM_STEPS)))
    (line,) = _bench_lines(run, 1, "images/sec")
    want = (f"images/sec/chip 256x256 DDIM-{BENCH_DDIM_STEPS} sampling "
            f"(batch 16, bf16)")
    (record,) = run["records"]
    if line["metric"] != want:
        fail(f"tools: bench metric {line['metric']!r}, expected {want!r}")
    if record["attention_launches"] != 4 * BENCH_DDIM_STEPS * BENCH_SAMPLE_REPS \
            or record["attention_bwd_launches"]:
        fail(f"tools: {BENCH_SAMPLE_REPS} DDIM-{BENCH_DDIM_STEPS} runs "
             f"launched the kernel {record['attention_launches']} times, "
             f"expected {4 * BENCH_DDIM_STEPS} a run")
    rec["bench_sample"] = dict(line=line, record=record, notes=run["notes"],
                               seconds=run["seconds"])
    run = _run_tool("bench_train", ["bench"], tmp, env=dict(
        BENCH_MODE="train", BENCH_REPS=str(BENCH_TRAIN_REPS)))
    (line,) = _bench_lines(run, 1, "steps/sec")
    (record,) = run["records"]
    if record["attention_launches"] != 4 * BENCH_TRAIN_REPS \
            or record["attention_bwd_launches"] != 4 * BENCH_TRAIN_REPS:
        fail(f"tools: {BENCH_TRAIN_REPS} train steps launched the forward "
             f"{record['attention_launches']} and the backward "
             f"{record['attention_bwd_launches']} times, expected 4 each a "
             f"step")
    rec["bench_train"] = dict(line=line, record=record, notes=run["notes"],
                              seconds=run["seconds"])
    rec["bench_launches"] = dict(
        sample=rec["bench_sample"]["record"]["attention_launches"],
        train=rec["bench_train"]["record"]["attention_launches"])

    # ------------------------------------------------------------ the rest
    # Seven chains at once, the bench done: the six chains of tools and the
    # parallel layer's world-1 NCCL rank. Their times are not measured
    # figures, and one tool's start-up (~8 s) would otherwise follow
    # another's. Their memory fits beside each other on the card, unlike
    # the gloo ranks' (an OOM in a trial). A failing chain stops the run
    # (fail() raises SystemExit, which its future re-raises here).
    committed = json.loads(COMMITTED_EVAL.read_text())
    weights = ROOT / committed["checkpoint"]
    chains = {"eval": lambda: _tools_eval(tmp, committed, weights),
              "sweep": lambda: _tools_sweep(tmp, weights),
              "export": lambda: _tools_export(tmp, loop_ckpt),
              "demo_e2e": lambda: _tools_demo(tmp, "demo_e2e", DEMO_ARGV[
                  "demo_e2e"] + ["--keep", tmp / "demo_e2e"]),
              "demo_staged": lambda: _tools_demo(tmp, "demo_staged", DEMO_ARGV[
                  "demo_staged"] + ["--keep", tmp / "demo_staged"]),
              "demo_cfg": lambda: _tools_cfg(tmp),
              "world1": lambda: phase_world1(tmp)}
    with ThreadPoolExecutor(max_workers=len(chains)) as pool:
        futures = {name: pool.submit(fn) for name, fn in chains.items()}
        for name, fut in futures.items():
            rec.update(fut.result())
    return rec


def _tools_eval(tmp: Path, committed: dict, weights: Path) -> dict:
    """eval_flagship at the committed operating point, then rescore_metrics
    and make_preview_grid of the images it saved."""
    from hybrid_diffusion_tpu_torch.data.registry import _png_decode

    ev_dir = tmp / "ev"
    run = _run_tool("eval_flagship", [
        "scripts.eval_flagship", "--ckpt", weights,
        "--sampler", committed["sampler"], "--ddim_steps", committed["steps"],
        "--guidance", committed["guidance"], "--save_images",
        "--out_dir", ev_dir, "--out", tmp / "ev.json"], tmp,
        threads=TOOL_THREADS)
    ev = json.loads((tmp / "ev.json").read_text())
    for domain, want in committed["results"].items():
        got = ev["results"].get(domain, {})
        if got.get("n_images") != want["n_images"] or not _finite_tree(got):
            fail(f"tools: eval_flagship {domain}: {got}, expected "
                 f"{want['n_images']:.0f} images and finite metrics")
        if got["psnr"] < want["psnr"] - EVAL_PSNR_GAP_DB:
            fail(f"tools: eval_flagship {domain} PSNR {got['psnr']} dB, "
                 f"more than {EVAL_PSNR_GAP_DB} dB below the committed "
                 f"{want['psnr']}")
    out = {"eval": dict(results=ev["results"], seconds=run["seconds"],
                        committed={d: {k: r[k] for k in ("psnr", "ssim")}
                                   for d, r in committed["results"].items()})}
    # The preview grid beside rescore: both only read the saved images.
    grid = tmp / "grid.png"
    with ThreadPoolExecutor(max_workers=1) as pool:
        grid_run = pool.submit(_run_tool, "preview_grid", [
            "scripts.make_preview_grid", "--results",
            ev_dir / "result" / "synthetic-underwater" / "val",
            "--dataset", "synthetic-underwater", "--size", "256",
            "--synthetic_length", "512", "--rows", "3", "--out", grid], tmp,
            threads=TOOL_THREADS)
        run = _run_tool("rescore", [
            "scripts.rescore_metrics", "--root", ev_dir / "result",
            "--size", "256", "--synthetic_length", "512",
            "--out", tmp / "rescore.json"], tmp,
            threads=TOOL_THREADS)
        grid_seconds = grid_run.result()["seconds"]
    rs = json.loads((tmp / "rescore.json").read_text())
    for domain, got in ev["results"].items():
        if rs.get(domain, {}).get("n_images") != got["n_images"] or abs(
                rs[domain]["psnr"] - got["psnr"]) > RESCORE_PSNR_ATOL:
            fail(f"tools: rescore {domain} {rs.get(domain)} against "
                 f"eval_flagship's {got}")
    out["rescore"] = dict(results=rs, seconds=run["seconds"])
    img = _png_decode(grid.read_bytes())
    if img is None or img.shape != (3 * 256, 3 * 256, 3):
        fail(f"tools: the preview grid is "
             f"{None if img is None else img.shape}, expected (768, 768, 3)")
    out["preview_grid"] = dict(shape=list(img.shape), seconds=grid_seconds)
    return out


def _tools_sweep(tmp: Path, weights: Path) -> dict:
    run = _run_tool("sweep", [
        "scripts.sweep_sampler", "--ckpt", weights,
        "--points", "ddim:15", "dpm++2m:5",
        "--synthetic_length", TOOLS_SHORT_LENGTH,
        "--out", tmp / "sweep.json"], tmp,
        threads=TOOL_THREADS)
    sw = json.loads((tmp / "sweep.json").read_text())
    if [(r["sampler"], r["steps"]) for r in sw["rows"]] != [
            ("ddim", 15), ("dpm++2m", 5)] or not _finite_tree(sw) or any(
            "psnr" not in res for r in sw["rows"]
            for res in r["results"].values()):
        fail(f"tools: sweep_sampler wrote {sw}")
    return {"sweep": dict(rows=sw["rows"], seconds=run["seconds"])}


def _tools_export(tmp: Path, loop_ckpt: Path) -> dict:
    """export_params of the loop's checkpoint, then eval_flagship of the
    npz it wrote."""
    exported = tmp / "export.npz"
    run = _run_tool("export", [
        "scripts.export_params", "--ckpt", loop_ckpt, "--out", exported], tmp,
        threads=TOOL_THREADS)
    side = json.loads((tmp / "export.npz.json").read_text())
    if side["subtree"] not in ("params", "ema_params") or side["step"] is None:
        fail(f"tools: export_params sidecar {side}")
    run2 = _run_tool("export_eval", [
        "scripts.eval_flagship", "--ckpt", exported, "--sampler", "dpm++2m",
        "--ddim_steps", "5", "--synthetic_length", TOOLS_SHORT_LENGTH,
        "--out_dir", tmp / "ev_export", "--out", tmp / "ev_export.json"], tmp,
        threads=TOOL_THREADS)
    ex = json.loads((tmp / "ev_export.json").read_text())
    if set(ex["results"]) != {"underwater", "atmospheric"} or not all(
            math.isfinite(r.get("psnr", float("nan")))
            for r in ex["results"].values()):
        fail(f"tools: the exported checkpoint evaluated to {ex}")
    return {"export": dict(sidecar=side, results=ex["results"],
                           seconds=run["seconds"],
                           eval_seconds=run2["seconds"])}


# The keys a demo's JSON holds only once it has reached its verdict.
DEMO_VERDICT_KEYS = {"demo_e2e": ("untrained", "trained",
                                  "degraded_input_baseline"),
                     "demo_staged": ("trained", "degraded_input_baseline"),
                     "demo_cfg": ("sweep", "guidance_lift"),
                     "regen_cfg_grids": ("sweep",)}


def _tools_demo(tmp: Path, name: str, argv: list) -> dict:
    """One demo; exit 1 is a demo's own verdict (too few steps to beat its
    baseline) when it ran to that verdict: no traceback, and its JSON holds
    the verdict's keys, with finite values. regen_cfg_grids has no
    verdict: exit 0 only."""
    run = _run_tool(name, [f"scripts.{name}"] + argv + [
        "--out", tmp / f"{name}.json"], tmp,
        ok_codes=(0,) if name == "regen_cfg_grids" else (0, 1),
        threads=TOOL_THREADS)
    out = json.loads((tmp / f"{name}.json").read_text())
    missing = [k for k in DEMO_VERDICT_KEYS[name] if k not in out]
    if missing:
        fail(f"tools: {name} exited {run['rc']} without {missing} in its "
             f"JSON: {out}")
    if not _finite_tree(out):
        fail(f"tools: {name} wrote non-finite values: {out}")
    return {name: dict(rc=run["rc"], seconds=run["seconds"], summary=out)}


def _tools_cfg(tmp: Path) -> dict:
    """demo_cfg, then regen_cfg_grids of the cfg_params.npz it wrote."""
    out = _tools_demo(tmp, "demo_cfg", DEMO_ARGV["demo_cfg"]
                      + ["--keep", tmp / "cfg"])
    out.update(_tools_demo(tmp, "regen_cfg_grids", DEMO_ARGV[
        "regen_cfg_grids"] + ["--params", tmp / "cfg" / "cfg_params.npz"]))
    return out


def fwd_bwd_fields(g: dict) -> dict:
    """A kernels-record row's forward + backward keys from phase_grad's row."""
    return {"fwd_bwd_shape": [g["B"], g["N"], g["h"], g["d"]],
            "fwd_bwd_ms": g["fwd_bwd_ms"],
            "fwd_bwd_bound_ms": g["fwd_bwd_bound_ms"],
            "fwd_bwd_bound_by": g["fwd_bwd_bound_by"],
            "sdpa_fwd_bwd_ms": g["sdpa_fwd_bwd_ms"],
            "grad_max_abs_err": g["grad_max_abs_err"],
            "grad_rel_err": g["grad_rel_err"]}


def forward_row(row: dict, launches: int) -> dict:
    """A kernels-record row of a forward kernel from phase_kernel's row: the
    kernel its dispatch chose, its launches on a main path, its error
    against the fp32 plain version, its time, its host time, its bound,
    the plain version's and SDPA's times."""
    return {
        "name": row["kernel"],
        "shape": [row["B"], row["N"], row["h"], row["d"]],
        "route": "cuda",
        "kernel": row["route"],
        "source": "hybrid_diffusion_tpu_torch/csrc/attention.cu",
        "replaces": "hybrid_diffusion_tpu/ops/attention.py:63",
        "launches": launches,
        "max_abs_err": row["max_abs_err"],
        "ms": row["kernel_ms"],
        "host_ms": row["kernel_host_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }


def backward_row(g: dict, launches: int, **extra) -> dict:
    """A kernels-record row of the backward kernel from phase_grad's row:
    the kernel its dispatch chose, its launches on a main path, its error
    against the fp32 plain version's autograd, its time, its plain twin's
    and SDPA's backward alone."""
    return {
        "name": "attention_bwd_fp32" if g["dtype"] == "float32"
                else "attention_bwd",
        "shape": [g["B"], g["N"], g["h"], g["d"]],
        "route": "cuda",
        "kernel": g["bwd_route"],
        "source": "hybrid_diffusion_tpu_torch/csrc/attention.cu",
        "replaces": "hybrid_diffusion_tpu/ops/attention.py:98",
        "launches": launches,
        "max_abs_err": g["grad_max_abs_err"],
        "grad_rel_err": g["grad_rel_err"],
        "grad_tol": g["grad_tol"],
        "ms": g["bwd_ms"],
        "plain_ms": g["plain_bwd_ms"],
        "bound_ms": g["bwd_bound_ms"],
        "bound_by": g["bwd_bound_by"],
        "library_ms": g["sdpa_bwd_ms"],
        "dq_spread": g["dq_spread"],
        **fwd_bwd_fields(g), **extra,
    }


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
    from hybrid_diffusion_tpu_torch.diffusion import (
        dpm_solver_pp_2m_sample, linear_beta_schedule)
    from hybrid_diffusion_tpu_torch.train.loop import build_model, make_sampler
    from hybrid_diffusion_tpu_torch.train.step import normalize_uint8
    from hybrid_diffusion_tpu_torch.utils import cuda_build
    from hybrid_diffusion_tpu_torch.utils.timing import device_ms, host_ms
    from hybrid_diffusion_tpu_torch.weights import load_npz_state_dict

    set_tf32(torch, (False, False))
    smi = cuda_build.nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    phase_done("env", t0, f"python {sys.version.split()[0]} torch "
               f"{torch.__version__} cuda {torch.version.cuda} | {smi} | "
               f"TF32 off for matmul and cuDNN")

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    built = phase_build(att, cuda_build)
    phase_done("build", t0, f"nvcc {built.build_seconds:.2f}s, every "
               f"tensor-core kernel shows its route's opcodes (HGMMA and TMA, "
               f"or HMMA), no kernel spills")

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

    # The full-precision serving mode (bf16=False) at full width: one
    # request of 8 through the fp32 kernel, with the caller's TF32 flags at
    # PyTorch's defaults (cuDNN's on), then the same request with them off.
    # The Enhancer sets its own precision, so both give the same bytes, and
    # the caller's flags are as they were after each call.
    enh32 = Enhancer(flagship_config(bf16=False), FLAGSHIP_NPZ, max_batch=8,
                     device="cuda")
    fp32_outs = {}
    for flags in (TF32_DEFAULTS, (False, False)):
        set_tf32(torch, flags)
        enh32._generator.manual_seed(enh32.config.seed)
        att.reset_launch_count()
        t_req = time.perf_counter()
        outs = enh32.enhance(list(requests[0]))
        if flags == TF32_DEFAULTS:
            fp32_ms = (time.perf_counter() - t_req) * 1e3
            fp32_serve_launches = att.launch_counts["attention_fwd_fp32"]
        if tf32_flags(torch) != flags:
            fail(f"the fp32 request left the caller's TF32 flags at "
                 f"{tf32_flags(torch)}, they were {flags}")
        if att.launch_counts["attention_fwd_fp32"] != 20 \
                or att.launch_count != 20:
            fail(f"the fp32 request launched the kernels {att.launch_counts} "
                 f"times, expected the fp32 kernel 20 times and no other")
        if len(outs) != 8 or int(np.ptp(np.stack(outs))) == 0:
            fail("the fp32 request gave no or constant outputs")
        fp32_outs[flags] = np.stack(outs)
    set_tf32(torch, (False, False))
    if not np.array_equal(*fp32_outs.values()):
        diff = np.abs(np.subtract(*[o.astype(int) for o in
                                    fp32_outs.values()])).max()
        fail(f"the fp32 request under PyTorch's TF32 defaults differs from "
             f"the one with TF32 off (max |diff| {diff})")
    del enh32
    phase_done("serve", t0, (
        f"bf16: {n_img} images in {calls} calls, {serve_s:.3f}s, "
        f"{n_img / serve_s:.2f} img/s, call latencies "
        f"{[round(x * 1e3, 1) for x in latencies]} ms, attention launches "
        f"{launches} ({launches // calls} per call), peak memory "
        f"{peak_gib:.2f} GiB; fp32: one call of 8 {fp32_ms:.1f} ms under "
        f"PyTorch's TF32 defaults, {fp32_serve_launches} fp32 attention "
        f"launches, the same bytes as with TF32 off, the caller's flags "
        f"kept | {smi}"))

    # ---------------------------------------------------------------- export
    t0 = time.perf_counter()
    ex = phase_export(att, torch, np, enh, requests[0])
    del enh
    phase_done("export", t0, (
        f"export_enhancer of the flagship Enhancer (bf16, batch 8, "
        f"DPM++2M-5) {ex['export_s']:.2f}s, {ex['mib']:.1f} MiB; "
        f"load_exported {ex['load_s']:.2f}s; one call launched the bf16 "
        f"kernel 20 times; {ex['bytes_diff']} bytes off the Enhancer's on "
        f"the same noise (max {ex['max_diff']} levels, limit "
        f"{EXPORT_MAX_LEVELS}); call {ex['exported_call_ms']:.1f} ms "
        f"exported, {ex['enhancer_call_ms']:.1f} ms Enhancer | {smi}"))

    # ---------------------------------------------------------------- http
    t0 = time.perf_counter()
    hp = phase_http(att, torch, np, Enhancer, flagship_config)
    phase_done("http", t0, (
        f"serve_http over the flagship Enhancer (max_batch 1): POST /enhance "
        f"256², 300×200, 256² ?size=128x96 in "
        f"{[round(x, 1) for x in hp['latency_ms']]} ms, 20 launches each; "
        f"/healthz, /stats ok; a bad body got {hp['bad_body_code']} | {smi}"))

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
    # What the fp32 mode gave before it set its own precision: the same
    # sampler with cuDNN's TF32 on (PyTorch's default), outside the
    # Enhancer's precision context.
    cfg = dataclasses.replace(cfg64, bf16=False)
    model = build_model(cfg)
    model.load_state_dict(state, strict=True)
    model = model.to("cuda").eval()
    set_tf32(torch, TF32_DEFAULTS)
    tf32_out = dpm_solver_pp_2m_sample(
        lambda x6, t, context_zero=True: model(x6, t,
                                               context_zero=context_zero),
        linear_beta_schedule(cfg.beta_1, cfg.beta_T, cfg.T),
        normalize_uint8(torch.from_numpy(cond).cuda()),
        steps=cfg.ddim_step, init_noise=torch.from_numpy(noise).cuda())
    set_tf32(torch, (False, False))
    tf32_out = ((tf32_out + 1.0) / 2.0).cpu().numpy().astype(np.float64)
    tf32_db = psnr(tf32_out, cpu)
    detail.append(f"card fp32 with TF32 convolutions (the old default) vs "
                  f"CPU fp32: max |diff| {np.abs(tf32_out - cpu).max():.3e}, "
                  f"PSNR {tf32_db:.2f} dB; vs the card's fp32 path: PSNR "
                  f"{psnr(tf32_out, outs['cuda', False]):.2f} dB")
    phase_done("path", t0, "64² batch 2 DPM++2M-5; " + "; ".join(detail))
    del state

    # ---------------------------------------------------------------- train
    t0 = time.perf_counter()
    train = phase_train(att, torch, np, smi)
    phase_done("train", t0, (
        f"{train['steps']} flagship steps (256², batch 16, bf16, "
        f"default loss with DINO): median step {train['median_step_ms']:.1f} "
        f"ms after the first, peak memory {train['peak_gib']:.2f} GiB, "
        f"attention launches {train['launches']} forward and "
        f"{train['bwd_launches']} backward (4 each per step) | {smi}"))

    # ---------------------------------------------------------------- tparity
    t0 = time.perf_counter()
    tp = phase_train_parity(att, torch, np)
    phase_done("tparity", t0, (
        f"fp32 64² batch 2 step, card vs CPU: loss rel {tp['loss_rel']:.3e} "
        f"(limit {TRAIN_LOSS_RTOL}), gradients rel {tp['grad_rel']:.3e} "
        f"(limit {tp['grad_bound']:.3e}, κ {tp['kappa']:.3e}); with TF32 "
        f"on: loss rel {tp['tf32_loss_rel']:.3e}, gradients rel "
        f"{tp['tf32_grad_rel']:.3e}; fp32 attention launches "
        f"{tp['launches']} forward and {tp['bwd_launches']} backward (4 each "
        f"a card step)"))

    # ---------------------------------------------------------------- loop

    tmp = Path(tempfile.mkdtemp(prefix="hdt_chip_smoke_"))
    tools_tmp = Path(tempfile.mkdtemp(prefix="hdt_chip_tools_"))
    try:
        t0 = time.perf_counter()
        lp = phase_loop(att, torch, np, tmp)
        phase_done("loop", t0, (
            f"cli train at the flagship width (256², batch 16, bf16, "
            f"default loss with DINO, EMA, r5 warm start), synthetic corpus: "
            f"{lp['steps']} steps in 2 stages, median step inside train() "
            f"{lp['median_step_ms']:.1f} ms, median gap between steps "
            f"{lp['median_gap_ms']:.1f} ms, probe calls (DPM++2M-15, batch "
            f"{lp['probe_batch']}) {[round(x, 1) for x in lp['probe_call_ms']]}"
            f" ms, saves {[round(x) for x in lp['save_ms']]} ms of "
            f"{lp['save_gib']:.3f} GiB each, export subtree {lp['export']}; "
            f"resumed at step {lp['resumed_from']} and took "
            f"{lp['resumed_steps']} more; attention launches "
            f"{lp['launches']} forward (4 a step, 60 a probe call) and "
            f"{lp['bwd_launches']} backward (4 a step) | {smi}"))
        print("  loop " + json.dumps(lp), flush=True)

        # ------------------------------------------------------------ eval
        t0 = time.perf_counter()
        ev = phase_eval(att, torch, np, tmp)
        res = ev["results"]
        n_img = sum(r["n_images"] for r in res.values())
        wall = sum(r["sample_wall_s"] for r in res.values())
        phase_done("eval", t0, (
            f"cli test, DPM++2M-5, FID (He-rescaled random Inception) on: "
            f"{n_img} images in {ev['sampler_calls']} sampler calls, "
            f"sample_wall_s {wall:.3f} ({n_img / wall:.2f} img/s), "
            f"fetch_block_s "
            f"{sum(r['fetch_block_s'] for r in res.values()):.3f}, "
            f"fid_block_s {sum(r['fid_block_s'] for r in res.values()):.3f}, "
            f"time_cost "
            f"{sum(r['time_cost'] for r in res.values()):.3f}s; "
            + "; ".join(f"{d}: PSNR {r['psnr']:.2f} SSIM {r['ssim']:.4f} "
                        f"UIQM {r['uiqm']:.3f} FID {r['fid']:.4f}"
                        for d, r in res.items())
            + f"; attention launches {ev['launches']} (20 a batch) | {smi}"))
        print("  eval " + json.dumps(ev), flush=True)

        # ------------------------------------------------------------ cfg
        t0 = time.perf_counter()
        cf = phase_cfg(att, torch, np, tmp)
        phase_done("cfg", t0, (
            f"train_cfg at CFGConfig() (batch 80, 32², ch 128, T 500, bf16), "
            f"{len(cf['train_step_ms'])} steps in "
            f"{[round(x, 1) for x in cf['train_step_ms']]} ms, peak "
            f"{cf['train_peak_gib']:.2f} GiB, 21 forward and 21 backward "
            f"launches a step, the backward by shape "
            f"{cf['train_bwd_launches_by_shape']}; evaluate_cfg (w 1.8, 10 × 8 "
            f"grid, T 500): {cf['eval_calls']} calls of 2B = {CFG_BATCH} in "
            f"{cf['eval_s']:.2f}s, {cf['images_per_s']:.2f} img/s, peak "
            f"{cf['eval_peak_gib']:.2f} GiB; attention launches a call by "
            f"shape {cf['launches_per_call']} (21); card fp32 forward vs CPU "
            f"{cf['fp32_fwd_rel']:.3e} of max|out| (limit "
            f"{cf['fp32_fwd_bound']:.3e}) | {smi}"))
        print("  cfg " + json.dumps(cf), flush=True)
        # The tools phase exports the loop's last checkpoint.
        loop_ckpt = tools_tmp / "loop_ckpt"
        shutil.move(lp["last_checkpoint"], loop_ckpt)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---------------------------------------------------------------- ddpm
    t0 = time.perf_counter()
    dd = phase_ddpm(att, torch, np)
    phase_done("ddpm", t0, (
        f"flagship npz, 64² batch 2, fp32, make_sampler ddpm over T "
        f"{dd['steps']}: {dd['chain_s']:.2f}s ({dd['ms_per_step']:.2f} ms a "
        f"step), {dd['launches']} fp32 launches, output mean "
        f"{dd['out_mean']:.4f} std {dd['out_std']:.4f}; one step card vs "
        f"CPU rel {dd['step_rel']:.3e} (limit {DDPM_STEP_RTOL}), ε rel "
        f"{dd['eps_rel']:.3e} | {smi}"))

    # ---------------------------------------------------------------- vgg
    t0 = time.perf_counter()
    vg = phase_vgg(att, torch, np)
    phase_done("vgg", t0, (
        f"{vg['steps']} flagship steps (256², batch 16, bf16) under "
        f"--stage1_losses {STAGE1_LOSSES!r}, vgg16 random init: median step "
        f"{vg['median_step_ms']:.1f} ms after the first, peak memory "
        f"{vg['peak_gib']:.2f} GiB, 4 attention launches a step | {smi}"))

    # ---------------------------------------------------------------- parallel
    # The spawned ranks need the card's memory this process still caches.
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="hdt_chip_parallel_"))
    try:
        t0 = time.perf_counter()
        par = phase_parallel(torch, np, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = par["ranks"][0]
    tp_row = rows[TP_CASE]
    for r, rank in enumerate(par["ranks"]):
        print("  parallel rank " + str(r) + " " + json.dumps({
            case: dict(step_ms=rec["step_ms"], peak_gib=rec["peak_gib"],
                       launches=rec["launches"])
            for case, rec in rank["bf16"].items()}) + f" | {smi}", flush=True)
    print("  parallel " + json.dumps(dict(
        bf16={c: {k: v for k, v in rec.items()
                  if k in ("loss_rel", "grad_norm_rel")}
              for c, rec in r0["bf16"].items()},
        fp32=r0["fp32"], sampler=r0["sampler"],
        gloo_refuses_on_cuda=list(GLOO_REFUSED_ON_CUDA))), flush=True)
    phase_done("parallel", t0, (
        f"two gloo ranks on cuda:0 in {par['gloo_seconds']:.1f}s: step ms a "
        f"rank (median of the second) " + ", ".join(
            f"{c} {m:.1f}" for c, m in r0["step_ms_median"].items())
        + "; bf16 vs one process (loss, grad norm rel, bound "
        f"{PAR_BF16_RTOL:.2e}) " + ", ".join(
            f"{c} {rec['loss_rel']:.1e}/{rec['grad_norm_rel']:.1e}"
            for c, rec in r0["bf16"].items())
        + f"; fp32 64² gradients rel " + ", ".join(
            f"{c} {r0['fp32'][c]['grad_rel']:.1e} "
            f"({r0['fp32']['seconds'][c]:.2f}s)"
            for c, _, _ in PAR_FP32_CASES)
        + f" (bound {r0['fp32']['grad_bound']:.1e}, κ "
        f"{r0['fp32']['kappa']:.1e}; {par['fp32_bwd_launches']} fp32 backward "
        f"launches, 4 a step); sampler {r0['sampler']['max_levels']} "
        f"level(s) on {r0['sampler']['share']:.2e} of the bytes; "
        f"head-sharded kernel {par['tp_shape']}: {par['tp_launches']} "
        f"forward launches, {tp_row['kernel_ms']:.5f} ms (SDPA "
        f"{tp_row['library_ms']:.5f} ms), {par['tp_bwd_launches']} backward "
        f"launches, {grad_rows[TP_CASE]['bwd_ms']:.5f} ms (SDPA's backward "
        f"{grad_rows[TP_CASE]['sdpa_bwd_ms']:.5f} ms); gloo refuses on CUDA: "
        f"{', '.join(GLOO_REFUSED_ON_CUDA)} (checked at world 1 on the card "
        f"and at world 2-4 on the CPU); two ranks on one card are no scaling "
        f"figure | {smi}"))

    # ---------------------------------------------------------------- tools
    torch.cuda.empty_cache()
    try:
        t0 = time.perf_counter()
        tl = phase_tools(np, tools_tmp, loop_ckpt)
    finally:
        shutil.rmtree(tools_tmp, ignore_errors=True)
    for name in ("bench_sample", "bench_train"):
        for note in tl[name]["notes"]:
            print("  " + note, flush=True)
        print("  " + json.dumps(tl[name]["line"]), flush=True)
    sample, train_b, w1 = tl["bench_sample"], tl["bench_train"], tl["world1"]
    ev_res, committed = tl["eval"]["results"], tl["eval"]["committed"]
    print("  tools " + json.dumps({k: v for k, v in tl.items()
                                   if not k.startswith("bench")}), flush=True)
    phase_done("tools", t0, (
        f"bench: DDIM-{BENCH_DDIM_STEPS} 256² batch 16 bf16 "
        f"{sample['line']['value']} img/s (runs "
        f"{[round(x, 3) for x in sample['record']['wall_s']]} s, "
        f"{sample['record']['launches_per_run']:.0f} launches a run, one "
        f"U-Net call {sample['record']['unet_call_device_ms']} ms on the "
        f"card), train {train_b['line']['value']} steps/s"
        + "; eval_flagship (r5 npz, DPM++2M-5, 73 val a domain) "
        + ", ".join(f"{d} PSNR {r['psnr']} SSIM {r['ssim']} (committed "
                    f"{committed[d]['psnr']} / {committed[d]['ssim']})"
                    for d, r in ev_res.items())
        + f"; rescore, preview grid, sweep (ddim:15, dpm++2m:5), export "
        f"({tl['export']['sidecar']['subtree']}) + eval, "
        + ", ".join(f"{n} rc {tl[n]['rc']}" for n in DEMO_ARGV)
        + f"; world 1 over NCCL: cli train --zero1 {w1['launches'] // 4} "
        f"steps + resume with --mesh_data 1 --mesh_model 1 to step "
        f"{w1['resumed_to']} + evaluate(), ring attention at world 1 within "
        f"{w1['ring_err']:.1e}; seconds " + ", ".join(
            f"{n} {tl[n]['seconds']:.1f}" for n in
            ("bench_sample", "bench_train", "eval", "rescore", "preview_grid",
             "sweep", "export", *DEMO_ARGV, "world1")) + f" | {smi}"))

    # Each kernel at the shape the serve phase gave it, with its launches
    # there: bf16 in the bf16 calls, fp32 in the full-precision request.
    # The bf16 kernel also carries its launches in the train phase and its
    # forward + backward at the train shape; the fp32 one, at the tparity
    # phase's shape.
    kernels = []
    grad_of = {"attention_fwd": grad_rows[TRAIN_CASE],
               "attention_fwd_fp32": grad_rows[FP32_GRAD_CASE]}
    for row, n in ((rows[SERVE_CASE], launches),
                   (rows[FP32_SERVE_CASE], fp32_serve_launches)):
        g = grad_of[row["kernel"]]
        kernels.append({
            **forward_row(row, n),
            "bench_launches": (tl["bench_launches"]
                               if row["kernel"] == "attention_fwd" else
                               dict(sample=0, train=0)),
            "train_launches": (train["launches"]
                               if row["kernel"] == "attention_fwd" else 0),
            "loop_launches": (lp["launches"]
                              if row["kernel"] == "attention_fwd" else 0),
            "eval_launches": (ev["launches"]
                              if row["kernel"] == "attention_fwd" else 0),
            **fwd_bwd_fields(g),
        })
    # The bf16 kernel at the four CFG shapes, with its launches there in the
    # cfg phase's evaluate_cfg run.
    for case in CFG_CASES:
        row, g = rows[case], grad_rows[case]
        kernels.append({
            **forward_row(row, cf["launches_by_shape"][
                f"N{row['N']} d{row['d']}"]),
            **fwd_bwd_fields(g),
        })
    # The bf16 kernel on the head-sharded shape, with its launches in the
    # parallel phase's TP steps (both ranks).
    g = grad_rows[TP_CASE]
    kernels.append({**forward_row(tp_row, par["tp_launches"]),
                    **fwd_bwd_fields(g)})
    # The backward kernel at the shapes the training paths gave it, with its
    # launches there: the train phase's flagship steps (the loop, vgg and
    # bench steps beside them), the cfg phase's train steps by shape, the
    # parallel phase's TP steps (both ranks).
    kernels.append(backward_row(
        grad_rows[TRAIN_CASE], train["bwd_launches"],
        loop_launches=lp["bwd_launches"], vgg_launches=vg["bwd_launches"],
        bench_train_launches=train_b["record"]["attention_bwd_launches"]))
    for case in CFG_TRAIN_CASES:
        B, N, h, d = case[:4]
        kernels.append(backward_row(
            grad_rows[case],
            cf["train_bwd_launches_by_shape"][f"B{B} N{N} h{h} d{d}"]))
    kernels.append(backward_row(grad_rows[TP_CASE], par["tp_bwd_launches"]))
    # The fp32 backward kernel at the tparity shape, with its launches in
    # the tparity phase's card steps and the parallel phase's fp32 steps;
    # beside it, its times at the fp32 flagship and CFG train shapes, which
    # no phase trains at.
    kernels.append(backward_row(
        grad_rows[FP32_GRAD_CASE], tp["bwd_launches"] + par["fp32_bwd_launches"],
        tparity_launches=tp["bwd_launches"],
        parallel_launches=par["fp32_bwd_launches"],
        tf32x3_floor_ms=grad_rows[FP32_GRAD_CASE]["bwd_tf32x3_floor_ms"],
        other_shapes={
            "B{} N{} h{} d{}".format(*case[:4]): {
                k: grad_rows[case][k] for k in (
                    "bwd_ms", "plain_bwd_ms", "sdpa_bwd_ms", "bwd_bound_ms",
                    "bwd_bound_by", "bwd_tf32x3_floor_ms", "fwd_bwd_ms",
                    "sdpa_fwd_bwd_ms", "grad_rel_err", "dq_spread")}
            for case in (FP32_TRAIN_CASE, FP32_CFG_TRAIN_CASE)}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
