"""The port's benchmark: DDIM sampling throughput at the reference operating
point (256², batch 16, 100 DDIM steps, the ch-128 U-Net), on the card.

    python -m hybrid_diffusion_tpu_torch.bench

Counterpart of the JAX package's root `bench.py`, with its modes, knobs and
output. Prints ONE JSON line per result on stdout: {"metric", "value",
"unit", "vs_baseline"}; what else it says goes to stderr on lines that
start with "#", among them one `# record {...}` JSON line with the device,
the wall-clock times of every timed run, the card's time of the same work
and the attention kernel's launches.

vs_baseline: the nominal single-GPU estimate of 1.0 image/s for 100-step
DDIM sampling of this U-Net at 256² batch 16 (bench.py:5-11 of the JAX
package); vs_baseline = images/s ÷ 1.0 (steps/s and µs for the other
modes, as there).

Modes (BENCH_MODE):
  unset   DDIM-100 (BENCH_SAMPLER=dpm++2m: DPM-Solver++(2M)) sampling of
          the U-Net at batch 16, 256², bf16 compute and GroupNorm outputs
          (as the JAX bench's norm_dtype), dropout 0, random weights from
          seed 0, cast to bf16 once before sampling (as the
          JAX bench casts its parameter tree: `cast_weights_once`); an
          untimed warm-up run of WARMUP_STEPS steps, then fresh noise every
          run from a generator seeded 2 + i on the device; the best of
          BENCH_REPS runs, each timed with the host clock between two
          torch.cuda.synchronize() calls.
  train   training steps/s at batch 16, 256²: the composite loss with the
          DINO term off, dropout 0.15, AdamW; knobs BENCH_ROUTING=0 (no
          domain routing), BENCH_LOSS=mse (MSE only), BENCH_REMAT=1
          (recomputed ResBlocks), BENCH_GRAD_ONLY=1 (forward, loss and
          backward only, no update).
  attn    the attention A/B at the U-Net bottleneck (B 16, N 1024, 8 heads
          of d 32, bf16): forward and forward + backward of chained calls,
          µs a call, for the arms `plain` (attention_reference, the plain
          PyTorch version, called as the A/B arm) and `kernel` (the
          wrapper, on the card the CUDA kernel with its recomputed
          backward).

The sampling and train modes always run the attention through the wrapper,
which on the card is the CUDA kernel (Config.use_pallas_attention has no
effect in the port). Other knobs: BENCH_BATCH, BENCH_STEPS, BENCH_SIZE,
BENCH_REPS, BENCH_TOKENS, BENCH_ITERS; BENCH_QUICK=1 makes the JAX bench's
small sizes the knobs' defaults. The card is the default: BENCH_DEVICE=cpu
runs on the CPU, where the wrapper is the plain version and nothing is
timed on a device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from .diffusion import ddim_sample, dpm_solver_pp_2m_sample, linear_beta_schedule
from .models import DynamicUNet
from .ops import attention as att
from .utils.device import resolve_device

REFERENCE_SINGLE_GPU_IMAGES_PER_SEC = 1.0  # nominal estimate, see docstring
WARMUP_STEPS = 2      # the sampling mode's untimed first run


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _note(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_model(quick: bool, dropout: float, remat: bool = False
                ) -> DynamicUNet:
    """The bench's U-Net (JAX bench.py:256-270): ch 128, mult (1,2,2,2), 2
    res blocks, T 1000, bf16 compute, every GroupNorm's output in bf16
    (its statistics and arithmetic in fp32, as the JAX bench's
    norm_dtype=bf16); ch 32, mult (1,2), 1 res block when quick. Random
    weights from seed 0; the global generator is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return DynamicUNet(
            T=1000, ch=32 if quick else 128,
            ch_mult=(1, 2) if quick else (1, 2, 2, 2),
            num_res_blocks=1 if quick else 2, dropout=dropout,
            dtype=torch.bfloat16, norm_dtype=torch.bfloat16, remat=remat)


@torch.no_grad()
def cast_weights_once(model: torch.nn.Module) -> torch.nn.Module:
    """Round every weight to bf16 once, in place, as the JAX bench casts its
    whole parameter tree before sampling (bench.py:275-281): the weights of
    a layer that computes in bf16 are stored in bf16, so its cast at every
    call does nothing; those of a layer that computes in fp32 (GroupNorm,
    the fp32 tail conv) keep their bf16-rounded values in fp32, as flax
    promotes bf16 parameters to such a layer's fp32."""
    for module in model.modules():
        in_bf16 = getattr(module, "dtype", None) == torch.bfloat16
        for p in module.parameters(recurse=False):
            p.data = p.data.to(torch.bfloat16)
            if not in_bf16:
                p.data = p.data.float()
    return model


def _event_ms(fn, device: torch.device):
    """(fn's result, the card's time from the start to the end of its
    work, CUDA events: waits on the host included); None off the card."""
    if device.type != "cuda":
        return fn(), None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _device_ms(fn, device: torch.device, **kwargs):
    """utils/timing.device_ms of fn: the card's time with the calls queued
    ahead of it; None off the card."""
    if device.type != "cuda":
        return None
    from .utils.timing import device_ms

    return device_ms(fn, **kwargs)


def _record(device: torch.device, **fields) -> None:
    """The `# record` line: this run's numbers and where they ran."""
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    _note("record " + json.dumps(dict(device=name, **fields)))


def bench_sample(quick: bool, device: torch.device) -> None:
    # Quick: the JAX bench's 4, 10, 64², 2 (bench.py:242-243), which the
    # knobs may override here, as in its train and attn modes.
    batch = _env_int("BENCH_BATCH", 4 if quick else 16)
    steps = _env_int("BENCH_STEPS", 10 if quick else 100)
    size = _env_int("BENCH_SIZE", 64 if quick else 256)
    reps = _env_int("BENCH_REPS", 2 if quick else 5)
    sampler_name = os.environ.get("BENCH_SAMPLER", "ddim")

    t0 = time.time()
    model = cast_weights_once(bench_model(quick, dropout=0.0).to(device).eval())
    _note(f"init {time.time() - t0:.0f}s; weights cast to bf16 once "
          f"(fp32 layers keep the bf16-rounded values in fp32); GroupNorm "
          f"outputs bf16")
    schedule = linear_beta_schedule(1e-4, 0.02, 1000)

    def denoise(x6, t, context_zero=True):
        return model(x6, t, context_zero=context_zero)

    cond = torch.zeros((batch, size, size, 3), device=device)

    def sample(seed: int, n_steps: int = steps) -> torch.Tensor:
        gen = torch.Generator(device).manual_seed(seed)
        if sampler_name == "dpm++2m":
            return dpm_solver_pp_2m_sample(denoise, schedule, cond, gen,
                                           steps=n_steps)
        return ddim_sample(denoise, schedule, cond, gen, ddim_steps=n_steps)

    # Warm-up: the first U-Net call carries the card's one-time set-up
    # (CUDA's lazy module loading, cuDNN's plans; on the H100 a first
    # DDIM-100 run at the flagship width took 21.1 s, the next ones 9.5 s),
    # and every later call has the same shapes. The JAX bench runs a whole
    # first sample, which compiles its scan.
    t0 = time.time()
    out = sample(1, min(steps, WARMUP_STEPS))
    _sync(device)
    _note(f"warm-up run ({min(steps, WARMUP_STEPS)} steps) "
          f"{time.time() - t0:.1f}s")
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("the warm-up sampling run gave non-finite values")

    att.reset_launch_count()
    times, spans = [], []
    for i in range(reps):
        _sync(device)
        t0 = time.time()
        _, span = _event_ms(lambda: sample(2 + i), device)
        _sync(device)
        times.append(time.time() - t0)
        spans.append(span)
    launches = att.launch_count
    best = min(times)
    images_per_sec = batch / best
    _note(f"times={['%.3f' % t for t in times]}")
    # The card's time of one denoiser call with its calls queued ahead of it
    # (its kernels alone), beside the events' span of each run.
    x6 = torch.zeros((batch, size, size, 6), device=device)
    t = torch.full((batch,), 500, dtype=torch.long, device=device)
    with torch.no_grad():
        call_ms = _device_ms(lambda: denoise(x6, t), device, reps=5, inner=1)
    _record(device, mode="sample", sampler=sampler_name, batch=batch,
            steps=steps, size=size, reps=reps, wall_s=times,
            event_span_ms=spans, unet_call_device_ms=call_ms,
            attention_launches=launches,
            launches_per_run=launches / reps,
            weights="bf16 once", norm_out="bf16")
    print(json.dumps({
        "metric": f"images/sec/chip {size}x{size} "
                  f"{'DPM++2M' if sampler_name == 'dpm++2m' else 'DDIM'}"
                  f"-{steps} sampling (batch {batch}, bf16)",
        "value": round(images_per_sec, 3),
        "unit": "images/sec",
        "vs_baseline": round(
            images_per_sec / REFERENCE_SINGLE_GPU_IMAGES_PER_SEC, 3),
    }), flush=True)


def _grad_only_step(schedule, loss_cfg):
    """The step's forward, loss and backward without the update (JAX
    bench.py:81-116): step(state, batch, generator) -> (state, parts)."""
    from .diffusion.process import predict_x0_from_eps, q_sample
    from .diffusion.schedule import DiffusionSchedule
    from .losses.composite import composite_enhancement_loss
    from .train.step import normalize_uint8

    tables = None

    def step(state, batch, generator):
        nonlocal tables
        device = next(iter(state.params.values())).device
        if tables is None:      # the schedule on the card once
            tables = DiffusionSchedule(**{
                f.name: torch.as_tensor(getattr(schedule, f.name),
                                        device=device)
                for f in dataclasses.fields(schedule)})
        inp = normalize_uint8(batch["input"])
        gt = normalize_uint8(batch["gt"])
        B = gt.shape[0]
        t = torch.randint(0, tables.num_steps, (B,), device=device,
                          generator=generator)
        noise = torch.randn(gt.shape, device=device, generator=generator)
        y_t = q_sample(tables, gt, t, noise)
        x6 = torch.cat([inp, y_t], dim=-1)
        state.optimizer.zero_grad(set_to_none=True)
        eps = state.model(x6, t, cond_image=inp, train=True,
                          generator=generator)
        x0 = predict_x0_from_eps(tables, y_t, t, eps)
        loss, parts = composite_enhancement_loss(eps, noise, x0, gt, loss_cfg)
        loss.backward()
        parts["gsum"] = sum(p.grad.float().sum() for p in
                            state.params.values() if p.grad is not None)
        parts["total"] = loss.detach()
        return state, parts

    return step


def bench_train(quick: bool, device: torch.device) -> None:
    from .losses import CompositeLossConfig
    from .train.step import make_train_step
    from .train.train_state import TrainState

    batch = _env_int("BENCH_BATCH", 4 if quick else 16)
    size = _env_int("BENCH_SIZE", 64 if quick else 256)
    reps = _env_int("BENCH_REPS", 2 if quick else 10)
    routing = os.environ.get("BENCH_ROUTING", "1") != "0"
    mse_only = os.environ.get("BENCH_LOSS", "full") == "mse"
    remat = os.environ.get("BENCH_REMAT", "0") == "1"
    grad_only = os.environ.get("BENCH_GRAD_ONLY", "0") == "1"

    model = bench_model(quick, dropout=0.15, remat=remat).to(device)
    schedule = linear_beta_schedule(1e-4, 0.02, 1000)
    # DINO off (no pretrained weights); MSE + MS-SSIM + colour, the
    # reference's live loss terms (JAX bench.py:74-79).
    loss_cfg = (CompositeLossConfig(dino_weight=0.0, ms_ssim_weight=0.0,
                                    color_weight=0.0)
                if mse_only else CompositeLossConfig(dino_weight=0.0))
    state = TrainState(model, total_epochs=1000, steps_per_epoch=100)
    step = (_grad_only_step(schedule, loss_cfg) if grad_only else
            make_train_step(schedule, loss_cfg, domain_routing=routing))

    rng = np.random.RandomState(0)
    batches = [{k: torch.from_numpy(rng.randint(0, 255, (batch, size, size, 3),
                                                np.uint8)).to(device)
                for k in ("input", "gt")} for _ in range(3)]
    gen = torch.Generator(device).manual_seed(1)
    t0 = time.time()
    state, m = step(state, batches[0], gen)
    first = float(m["total"])
    _note(f"first step {time.time() - t0:.1f}s")
    if not np.isfinite(first):
        raise RuntimeError(f"the first train step gave loss {first}")

    att.reset_launch_count()
    _sync(device)
    t0 = time.time()

    def run():
        nonlocal state, m
        for i in range(reps):
            state, m = step(state, batches[i % len(batches)], gen)

    _, span = _event_ms(run, device)
    _sync(device)
    seconds = time.time() - t0
    launches = att.launch_count
    last = float(m["total"])
    if not np.isfinite(last):
        raise RuntimeError(f"a train step gave loss {last}")
    sps = reps / seconds
    tag = (f"loss={'mse' if mse_only else 'composite'} "
           f"routing={'on' if routing else 'off'} attn=kernel"
           + (" remat" if remat else "")
           + (" grad-only" if grad_only else ""))
    _record(device, mode="train", batch=batch, size=size, reps=reps,
            wall_s=seconds, event_span_ms=span, attention_launches=launches,
            launches_per_step=launches / reps, last_loss=last,
            peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                      if device.type == "cuda" else None))
    print(json.dumps({
        "metric": f"train steps/sec {size}x{size} batch {batch} ({tag})",
        "value": round(sps, 3),
        "unit": "steps/sec",
        "vs_baseline": round(sps, 3),
    }), flush=True)


def bench_attn(quick: bool, device: torch.device) -> None:
    """Chained attention calls at the bottleneck shape, host clock between
    synchronizations, best of reps (JAX bench.py:156-229); beside each arm
    on a `#` line the card's time of one call (utils/timing.device_ms)."""
    B = _env_int("BENCH_BATCH", 2 if quick else 16)
    N = _env_int("BENCH_TOKENS", 64 if quick else 1024)
    h, d = 8, 32
    iters = _env_int("BENCH_ITERS", 4 if quick else 50)
    reps = _env_int("BENCH_REPS", 2 if quick else 7)
    fns = {"plain": att.attention_reference,
           "kernel": att.fused_spatial_attention}

    def inputs(seed: int):
        gen = torch.Generator(device).manual_seed(seed)
        return [torch.randn((B, N, h, d), generator=gen, device=device
                            ).to(torch.bfloat16) for _ in range(3)]

    def fwd_chain(fn, seed):
        q, k0, v0 = inputs(seed)
        with torch.no_grad():
            for _ in range(iters):
                q = fn(q, k0, v0)
        return q.float().sum()

    def bwd_chain(fn, seed):
        q, k0, v0 = inputs(seed)
        for _ in range(iters):
            qq = q.detach().requires_grad_()
            loss = (fn(qq, k0, v0).float() ** 2).sum()
            g = torch.autograd.grad(loss, qq)[0]
            q = g / (g.abs().max() + 1e-6)
        return q.float().sum()

    results, device_us = {}, {}
    for arm, fn in fns.items():
        for name, chain in (("fwd", fwd_chain), ("fwd+bwd", bwd_chain)):
            chain(fn, 0)                                   # warm
            _sync(device)
            att.reset_launch_count()
            times = []
            for r in range(reps):
                t0 = time.time()
                out = chain(fn, 1 + r)
                _sync(device)
                times.append(time.time() - t0)
            if not bool(torch.isfinite(out)):
                raise RuntimeError(f"attention {arm} {name} gave {out}")
            launches = att.launch_count
            us = min(times) / iters * 1e6
            results[f"{arm} {name}"] = round(us, 1)
            q, k, v = inputs(0)
            if name == "fwd":
                with torch.no_grad():
                    ms = _device_ms(lambda: fn(q, k, v), device)
            else:
                q.requires_grad_()

                def one():
                    out = fn(q, k, v)
                    return torch.autograd.grad((out.float() ** 2).sum(), q)

                ms = _device_ms(one, device, reps=15, inner=5)
            device_us[f"{arm} {name}"] = None if ms is None else ms * 1e3
            _record(device, mode="attn", arm=arm, pass_=name, B=B, N=N, h=h,
                    d=d, iters=iters, reps=reps, wall_s=times,
                    device_us_per_call=device_us[f"{arm} {name}"],
                    attention_launches=launches)
            print(json.dumps({
                "metric": f"attention {name} us/call {arm} "
                          f"(B={B} N={N} h={h} d={d}, bf16)",
                "value": round(us, 1),
                "unit": "us",
                "vs_baseline": round(us, 1),
            }), flush=True)
    _note(f"summary: {results}; device us a call: {device_us}")


def main() -> None:
    quick = bool(int(os.environ.get("BENCH_QUICK", "0")))
    device = resolve_device(os.environ.get("BENCH_DEVICE", "cuda"))
    mode = os.environ.get("BENCH_MODE")
    if mode == "train":
        bench_train(quick, device)
    elif mode == "attn":
        bench_attn(quick, device)
    elif mode:
        raise SystemExit(f"BENCH_MODE={mode!r}: expected train, attn or unset")
    else:
        bench_sample(quick, device)


if __name__ == "__main__":
    main()
