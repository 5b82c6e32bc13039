"""The benchmark's harness: finds a cell's pieces by name, runs the cell
once, and prints its result.

Everything that belongs to one cell is found from `BENCHMARK.json` and
files named after its entries, so a cell, a configuration or a metric is
added by adding files and entries:

  - `BENCHMARK.json`: the cells (`workloads`), their configuration and
    traffic names, and the metrics with the cells that report them;
  - `configs/<config>.json`: the deployment (model sizes, precision,
    weights, training recipe), with `source`, `reduced` and `assumed`;
  - `mixes/<traffic>.json`: the traffic's parameters, and under `driver`
    the name of the general driver that generates it;
  - `drivers/<driver>.py`: one driver per kind of entry point (serving,
    sampling, training); it sets the program up, runs the window and
    checks what the window produced against the plain reference;
  - `metrics/<metric>.py`, or `metrics/<stem>.py` for a metric named
    `<stem>.<suffix>`: the reader of a per-layer metric, with its data
    (kernel names) in `metrics/<stem>.json` beside it.

A driver module has:

    setup(run) -> state          program built, inputs made, shapes warm
    window(run, state) -> Window the measured window
    check(run, state) -> [Check] the comparison with the reference, run
                                 after the window with the program freed

The harness never imports the program itself; the drivers do.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
PROGRAM = "hybrid_diffusion_tpu_torch"
# Top-level module names that no run may hold once its window has closed
# (compared whole: the program's name starts with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "hybrid_diffusion_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Check:
    """One compared number and its limit; it passes when value ≤ limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Window:
    """What a driver's window measured.

    metrics: the end-to-end values it can give, by metric name;
    work: what it completed, for the per-layer readers ({"kind": ...,
    "model_calls": ..., "batch": ...});
    start_ns, end_ns: the window on the system clock (the profiler's);
    attempted, failed: requests or steps started, and those that failed.
    """

    metrics: dict
    work: dict
    start_ns: int
    end_ns: int
    attempted: int
    failed: int = 0


@dataclasses.dataclass
class Run:
    """One run of one cell: what a driver and a reader are handed."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    root: Path = ROOT
    events: Optional[list] = None        # trace.Event list of the window
    window: Optional[Window] = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def find_cell(name: str, root: Path = ROOT,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of BENCHMARK.json, with its configuration, mix and
    metrics read from their files."""
    spec = load_spec(root)
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(by_name)})")
    workload = by_name[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[workload["config"]]["file"])
    mix = load_json(bench_dir / "mixes" / f"{workload['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if m["moves"] in moved and _reports(m, name)]
    return Cell(name, workload, config, mix, e2e, per_layer)


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    if not (bench_dir / "drivers" / f"{name}.py").exists():
        raise KeyError(f"no driver {name!r} (drivers/{name}.py is missing)")
    return importlib.import_module(f"benchmark.drivers.{name}")


def reader_path(metric: str, bench_dir: Path = BENCH_DIR) -> Path:
    """metrics/<metric>.py, else metrics/<stem>.py for `<stem>.<suffix>`."""
    whole = bench_dir / "metrics" / f"{metric}.py"
    if whole.exists():
        return whole
    stem = bench_dir / "metrics" / f"{metric.split('.', 1)[0]}.py"
    if stem.exists():
        return stem
    raise KeyError(f"no reader for metric {metric!r} ({whole} is missing)")


def load_reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable:
    path = reader_path(metric, bench_dir)
    return _load_module(path, f"benchmark.metrics.{path.stem}").read


def limits(run: Run) -> dict:
    """The cell's limits: `limits/<cell>.json`'s "limits"."""
    return load_json(BENCH_DIR / "limits" / f"{run.cell.name}.json")["limits"]


def peaks() -> dict:
    return load_json(BENCH_DIR / "peaks.json")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between ranks."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def result_line(run: Run, window: Window, checks: list[Check],
                device: dict, per_layer: Optional[dict] = None,
                breakdown: Optional[dict] = None,
                setup_s: Optional[float] = None) -> dict:
    """The JSON object printed last: with --trace 0 the cell's end-to-end
    metrics, with --trace 1 its per-layer ones; `checks` last."""
    metrics = {}
    if run.trace:
        for m in run.cell.per_layer:
            if per_layer.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": per_layer[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in run.cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else \
                window.metrics[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": all(c.ok for c in checks) and window.failed == 0,
            "attempted": window.attempted, "failed": window.failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in checks}
    return line
