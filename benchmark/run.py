#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card(s) of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell's pieces are found by name
(harness.py). The run sets the program up (weights, inputs, warm shapes),
measures for `--seconds` seconds, then checks what the window produced
against the plain reference with the program's state freed. With
`--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a torch.profiler trace of the
window. The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are also the last lines of standard
error. The exit code is 0 when a result was printed, whether or not it is
correct; 2 when no card (or too few) is present, or when the process holds
a forbidden module (the JAX package or JAX) once the window has closed.

Build and kernel caches stay at fixed paths inside the checkout. The
process keeps to a fixed set of at most PINNED_CORES cores (the last of
those it may use), with at most that many torch threads: a host-paced
cell then does not move between cores while it runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# The checkout's root on the path, this folder off it (its modules are
# reached as `benchmark.<name>`, never shadowing a top-level module).
_HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _HERE]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import devtrace, harness  # noqa: E402

PINNED_CORES = 4


def pin_cores() -> None:
    """Keep this process, and every thread it starts from now on, on the
    last PINNED_CORES of the cores it may use."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[-PINNED_CORES:])


def _device_record(run: harness.Run, memory_peak: int) -> dict:
    import torch

    if run.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": memory_peak}
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.cell.workload["chips"],
            "memory_peak_bytes": memory_peak,
            "power_limit": smi[0].split(",")[-1].strip() if smi else "unknown"}


def _per_layer(run: harness.Run, window: harness.Window) -> dict:
    out = {}
    for metric in run.cell.per_layer:
        value = harness.load_reader(metric["name"])(run, metric)
        if value is not None:
            out[metric["name"]] = value
    return out


def run_cell(run: harness.Run) -> tuple[dict, int]:
    """Set up, measure, read the trace, check; (result line, exit code)."""
    import torch

    torch.set_num_threads(min(PINNED_CORES, torch.get_num_threads()))
    driver = harness.load_driver(run.mix["driver"])
    before = harness.process_age_s()
    state = driver.setup(run)
    cuda = run.device != "cpu"
    if cuda:
        torch.cuda.synchronize()
    profiler = devtrace.Profiler() if run.trace else None
    if profiler:
        profiler.__enter__()
    setup_s = harness.process_age_s()
    print(f"setup: {before:.2f} s to the driver, {setup_s - before:.2f} s in "
          f"its set-up", file=sys.stderr)
    window = driver.window(run, state)
    if cuda:
        torch.cuda.synchronize()
    if profiler:
        profiler.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_reserved() if cuda else 0
    run.window = window
    device = _device_record(run, memory_peak)
    per_layer = breakdown = None
    if profiler:
        run.events = profiler.events()
        del profiler
        w0, w1 = window.start_ns, window.end_ns
        device["busy_s"] = devtrace.busy_ns(run.events, w0, w1) / 1e9
        device["window_s"] = (w1 - w0) / 1e9
        per_layer = _per_layer(run, window)
        breakdown = {"device_ops": devtrace.device_ops(run.events, w0, w1),
                     "idle_gaps": devtrace.idle_gaps(run.events, w0, w1)}
        run.events = None
    checks = driver.check(run, state)
    line = harness.result_line(run, window, checks, device, per_layer,
                               breakdown, setup_s)
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return line, 2
    return line, 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    pin_cores()
    cell = harness.find_cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace))
    line, rc = run_cell(run)
    if rc:
        return rc
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
