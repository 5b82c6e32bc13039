#!/usr/bin/env python3
"""Readings that a cell's limits are set from, on the card.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        [--seconds 3]

For each seed, in one process: a run of the cell with a short window and
its check (the program's readings), then the control, the plain reference
with fp8 products put in the program's place on the same work (the
driver's `control`). One JSON line per seed on standard output, and the
largest program reading and smallest control reading of each number last.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import run as _run  # noqa: F401  (sets the path and the cache folders)
from benchmark import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    cell = harness.find_cell(args.workload)
    driver = harness.load_driver(cell.mix["driver"])
    program, low = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(cell, seed, args.seconds, False)
        state = driver.setup(run)
        run.window = driver.window(run, state)
        checks = driver.check(run, state)
        ctl = driver.control(run, state)
        readings = state.get("readings", {c.name: c.value for c in checks})
        row = {"seed": seed, "program": readings,
               "control": ctl, "metrics": run.window.metrics}
        print(json.dumps(row), flush=True)
        for k, v in readings.items():
            program[k] = max(program.get(k, 0.0), v)
        for k, v in ctl.items():
            if isinstance(v, float):
                low[k] = min(low.get(k, float("inf")), v)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"program_max": program, "control_min": low}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
