"""On the card, at each cell's own size: the program's run passes its
limits, and the control (the plain reference with fp8 products in the
program's place, on the same work) fails at least one of them. A short
window; one seed a cell. Skips where there is no card.

    python3 -m pytest benchmark/tests -m card
"""

from __future__ import annotations

import gc

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
SEED = 2**31 + 1001
SECONDS = {"cfg_sample": 21.0}   # a whole chain in the window


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name, cuda):
    import torch

    cell = harness.find_cell(name)
    driver = harness.load_driver(cell.mix["driver"])
    run = harness.Run(cell, SEED, SECONDS.get(cell.mix["driver"], 3.0),
                      False, device=cuda)
    state = driver.setup(run)
    run.window = driver.window(run, state)
    checks = driver.check(run, state)
    assert all(c.ok for c in checks), checks
    control = driver.control(run, state)
    limits = harness.limits(run)
    assert any(control[k] > v for k, v in limits.items() if k in control), \
        (control, limits)
    del state
    gc.collect()
    torch.cuda.empty_cache()


FAULT_SEEDS = (2**31 + 2001, 2**31 + 2002, 2**31 + 2003)


def _training_faults():
    from benchmark.tests import test_bench_faults as tf

    return [(n, f) for n, f in tf.FAULTS
            if n in CELLS
            and f not in (tf._update_skipped, tf._update_skipped_in_window)
            and harness.find_cell(n).mix["driver"] == "train"]


@pytest.mark.card
@pytest.mark.parametrize("name,fault", _training_faults(),
                         ids=[f"{n}-{f.__name__.strip('_')}"
                              for n, f in _training_faults()])
def test_training_faults_read_high(name, fault, cuda, monkeypatch, capsys):
    """A training cell's faults, planted in the program at the cell's own
    size, on three seeds: their readings (printed, for the limits' upper
    readings) fail the cell's limits."""
    import json

    import torch

    fault(monkeypatch)
    cell = harness.find_cell(name)
    driver = harness.load_driver(cell.mix["driver"])
    for seed in FAULT_SEEDS:
        run = harness.Run(cell, seed, 3.0, False, device=cuda)
        state = driver.setup(run)
        run.window = driver.window(run, state)
        checks = driver.check(run, state)
        with capsys.disabled():
            print("FAULT", json.dumps({"cell": name,
                                       "fault": fault.__name__,
                                       "seed": seed,
                                       "readings": state["readings"]}))
        assert not all(c.ok for c in checks), checks
        del state
        gc.collect()
        torch.cuda.empty_cache()
