"""Where the flagship training step's time goes inside train().

    python -m hybrid_diffusion_tpu_torch.profile_loop

Runs `train()` through the CLI's flags on the card at the flagship width
(256², batch 16, bf16, the default loss with DINO, dropout 0.15, domain
routing, EMA 0.99875, lr 1e-5, warm-started from the r5 npz) on the
synthetic corpus, one atmospheric epoch, with no probe and no periodic
save (the stage-final save runs after the windows), twice: with the host
loader (BatchLoader's worker threads and device_prefetch) and with the
corpus resident on the card (--device_data). After WARMUP steps, WINDOW
steps are timed with the host clock, with no synchronize between them, as
train() runs them; the next WINDOW steps run under torch.profiler, for the
device's busy share (the union of its kernels' and copies' intervals over
the window's wall time). Then the same step function runs the timed
window's batches again, staged on the card beforehand, timed the same way
(three times, median), so the difference is what the loader, the prefetch
and the loop add. Prints one JSON line last. Checkpoints go to a temporary
directory that is removed at the end.
"""

from __future__ import annotations

import json
import shutil
import statistics
import tempfile
import time
from pathlib import Path

import torch

from .config import parse_config
from .ops import attention as att
from .train import loop
from .utils.cuda_build import nvidia_smi_line
from .utils.profiling import busy_us

FLAGSHIP_NPZ = (Path(__file__).resolve().parent.parent / "docs" / "assets"
                / "flagship256_r5_fp16.npz")
WARMUP = 2
WINDOW = 10
STEPS = WARMUP + 2 * WINDOW


def measure(device_data: bool) -> dict:
    """One train() run of STEPS steps; its windows and the bare steps."""
    tmp = Path(tempfile.mkdtemp(prefix="hdt_profile_loop_"))
    cfg = parse_config([
        "--state", "train", "--synthetic_data",
        "--synthetic_length", str(STEPS * 16), "--img_size", "256",
        "--batch_size", "16", "--bf16", "--ema_decay", "0.99875",
        "--lr", "1e-5", "--init_from_npz", str(FLAGSHIP_NPZ),
        "--epochs_stage_1", "1", "--epochs_stage_2", "0",
        "--save_checkpoint", "1000", "--checkpoint_dir", str(tmp / "ck"),
        "--output_path", str(tmp / "out")]
        + (["--device_data"] if device_data else []))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    record: dict = {"steps": 0, "batches": []}
    real_make = loop.make_train_step

    def make_train_step(*args, **kwargs):
        step = real_make(*args, **kwargs)
        record["step"] = step

        def profiled(state, batch, generator):
            i = record["steps"]
            if i in (WARMUP, WARMUP + WINDOW):
                torch.cuda.synchronize()
                record[f"t{i}"] = time.perf_counter()
            if i == WARMUP + WINDOW:
                prof.start()
                record["t_trace"] = time.perf_counter()
            if WARMUP <= i < WARMUP + WINDOW:
                record["batches"].append({k: v.clone()
                                          for k, v in batch.items()})
            out = step(state, batch, generator)
            record["steps"] += 1
            if record["steps"] == STEPS:
                torch.cuda.synchronize()
                record["t_end"] = time.perf_counter()
                prof.stop()
            record["state"], record["generator"] = state, generator
            return out

        return profiled

    loop.make_train_step = make_train_step
    try:
        att.reset_launch_count()
        loop.train(cfg)
        launches = att.launch_count
        timed_s = record[f"t{WARMUP + WINDOW}"] - record[f"t{WARMUP}"]
        traced_s = record["t_end"] - record["t_trace"]
        busy = busy_us(prof) / 1e6 / traced_s
        # The same step, on the window's batches already on the card.
        state, gen, step = record["state"], record["generator"], record["step"]
        bare = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for batch in record["batches"]:
                state, _ = step(state, batch, gen)
            torch.cuda.synchronize()
            bare.append((time.perf_counter() - t0) / WINDOW)
    finally:
        loop.make_train_step = real_make
        shutil.rmtree(tmp, ignore_errors=True)
    return {"device_data": device_data,
            "in_train_step_ms": timed_s / WINDOW * 1e3,
            "bare_step_ms": statistics.median(bare) * 1e3,
            "bare_step_ms_runs": [b * 1e3 for b in bare],
            "traced_step_ms": traced_s / WINDOW * 1e3,
            "device_busy_share": busy, "device_idle_share": 1 - busy,
            "attention_launches": launches}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_loop needs a CUDA device")
    runs = [measure(device_data) for device_data in (False, True)]
    smi = nvidia_smi_line()
    print(f"card: {smi}")
    for r in runs:
        print(f"{'card-resident corpus' if r['device_data'] else 'host loader'}"
              f": inside train() {r['in_train_step_ms']:.2f} ms a step over "
              f"{WINDOW} steps; bare step on staged batches "
              f"{r['bare_step_ms']:.2f} ms; traced window "
              f"{r['traced_step_ms']:.2f} ms a step, device busy "
              f"{100 * r['device_busy_share']:.1f}% (idle "
              f"{100 * r['device_idle_share']:.1f}%); attention launches "
              f"{r['attention_launches']} ({r['attention_launches'] // STEPS}"
              f" a step)")
    print(json.dumps({"card": smi, "window_steps": WINDOW, "runs": runs}))


if __name__ == "__main__":
    main()
