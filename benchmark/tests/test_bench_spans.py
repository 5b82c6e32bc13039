"""The readers of the program's spans (spans.py, metrics/resize_idle_pct,
step_device_ms, step_host_ms, loss_device_ms, update_device_ms), on
synthetic device events and span records; and, on the card, one traced
run of the enhance cell whose spans share the device trace's clock.

    python3 -m pytest benchmark/tests/test_bench_spans.py -m card
"""

from __future__ import annotations

import pytest

from benchmark import devtrace, harness, spans
from benchmark.devtrace import Event

MS = 1_000_000  # ns


class _Run:
    def __init__(self, events=()):
        self.events = list(events)
        self.window = harness.Window({}, {}, 0, 100 * MS, 1)


def _rec(name, lo, hi, device_ms=None):
    return {"id": 0, "name": name, "parent": None, "request": None,
            "start_ns": lo * MS, "end_ns": hi * MS, "attrs": {},
            "device_ms": device_ms}


@pytest.fixture
def records(monkeypatch):
    """Stand-in for the program's records: set `records.value`."""
    class Box:
        value: list = []

    monkeypatch.setattr(spans, "program_spans", lambda: Box.value)
    return Box


def test_resize_idle_is_the_idle_time_inside_the_resize_spans(records):
    read = harness.load_reader("resize_idle_pct.enhance")
    run = _Run([Event("k", True, 0, 30 * MS), Event("k", True, 50 * MS,
                                                     100 * MS),
                Event("cudaMemcpyAsync", False, 0, 100 * MS)])
    records.value = [
        _rec("enhance/resize_in", 20, 40),    # partly over the gap: 30..40
        _rec("enhance/resize_out", 45, 60),   # partly over the gap: 45..50
        _rec("enhance/resize_in", 35, 40),    # inside the first: counted once
        _rec("enhance/resize_out", -10, 5),   # before the window, busy
        _rec("enhance/sample", 30, 50),       # not a resize
        _rec("enhance/resize_in", 120, 130),  # after the window
    ]
    assert read(run, {}) == pytest.approx(15.0)
    records.value = [_rec("enhance/sample", 30, 50)]
    assert read(run, {}) is None


@pytest.mark.parametrize("metric,name,field", [
    ("step_device_ms.enhance", "sampler/step", "device"),
    ("step_host_ms.cfg_sample", "sampler/step", "host"),
    ("loss_device_ms.train", "train/loss", "device"),
    ("update_device_ms.train", "train/update", "device"),
])
def test_median_readers_read_their_spans_inside_the_window(records, metric,
                                                           name, field):
    read = harness.load_reader(metric)
    records.value = [_rec(name, 10, 13, 5.0), _rec(name, 20, 27, 9.0),
                     _rec(name, 30, 34, 7.0),
                     _rec(name, -5, 95, 100.0),      # begins before
                     _rec(name, 99, 150, 100.0),     # begins inside: counted
                     _rec("enhance/call", 40, 90, 50.0)]
    want = {"device": 8.0, "host": 5.5}[field]
    assert read(_Run(), {}) == pytest.approx(want)
    records.value = [_rec("enhance/call", 40, 90, 50.0)]
    assert read(_Run(), {}) is None


def test_a_program_without_the_recorder_gives_no_records(monkeypatch):
    monkeypatch.setattr(spans, "RECORDER", "json")      # has no spans()
    assert spans.program_spans() == []
    monkeypatch.setattr(spans, "RECORDER", "no_such_module_here")
    assert spans.program_spans() == []
    assert harness.load_reader("step_device_ms.enhance")(_Run(), {}) is None


@pytest.mark.card
def test_traced_enhance_spans_share_the_device_traces_clock(cuda):
    """A 3-s traced window of the enhance cell at its own size: inside each
    device call, every kernel launch between the host-to-device copy and
    the copy back lies inside that call's `enhance/sample` span, and each
    copy inside its own span; the cell's span metrics read."""
    import torch

    cell = harness.find_cell("flagship256-enhance-b8")
    driver = harness.load_driver(cell.mix["driver"])
    run = harness.Run(cell, 2**31 + 3001, 3.0, True, device=cuda)
    state = driver.setup(run)
    torch.cuda.synchronize()
    profiler = devtrace.Profiler()
    with profiler:
        run.window = driver.window(run, state)
        torch.cuda.synchronize()
    run.events = profiler.events()
    w = run.window
    recs = [r for r in spans.program_spans()
            if w.start_ns <= r["start_ns"] < w.end_ns]
    host = [e for e in run.events if not e.device]
    launches = [e for e in host if "LaunchKernel" in e.name]
    copies = [e for e in host if e.name == "cudaMemcpyAsync"]
    by_parent: dict = {}
    for r in recs:
        by_parent.setdefault(r["parent"], {})[r["name"]] = r
    calls = [r for r in recs if r["name"] == "enhance/call"]
    assert calls
    inside = lambda e, r: r["start_ns"] <= e.start_ns and \
        e.end_ns <= r["end_ns"]
    for call in calls:
        kids = by_parent[call["id"]]
        h2d, sample, d2h = (kids[k] for k in ("enhance/h2d", "enhance/sample",
                                              "enhance/d2h"))
        between = [e for e in launches
                   if h2d["end_ns"] <= e.start_ns < d2h["start_ns"]]
        assert between and all(inside(e, sample) for e in between)
        assert any(inside(e, h2d) for e in copies)
        assert any(inside(e, d2h) for e in copies)
    for metric in ("resize_idle_pct.enhance", "step_device_ms.enhance"):
        value = harness.load_reader(metric)(run, {})
        print(metric, value)
        assert value is not None and value >= 0
