"""The trace reductions and the per-layer readers, on synthetic traces."""

from __future__ import annotations

import pytest

from benchmark import devtrace, harness
from benchmark.devtrace import Event

MS = 1_000_000  # ns


def _ev(name, lo, hi, device=True):
    return Event(name, device, lo * MS, hi * MS)


def test_union_counts_overlap_once():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26), (30, 31)]
    assert devtrace.union(spans) == [(0, 15), (20, 31)]


def test_busy_is_the_union_inside_the_window():
    events = [_ev("k1", 0, 10), _ev("k2", 5, 15), _ev("copy", 40, 60),
              _ev("host", 0, 100, device=False), _ev("k3", 90, 120)]
    # window [2, 100): 2..15, 40..60, 90..100
    assert devtrace.busy_ns(events, 2 * MS, 100 * MS) == (13 + 20 + 10) * MS


def test_device_ops_sums_by_name_longest_first():
    events = [_ev("a", 0, 10), _ev("b", 10, 40), _ev("a", 50, 60),
              _ev("host", 0, 5, device=False)]
    assert devtrace.device_ops(events, 0, 100 * MS) == [["b", 0.03],
                                                        ["a", 0.02]]


def test_idle_gaps_are_labelled_by_the_innermost_open_host_event():
    events = [_ev("k", 0, 10), _ev("k", 30, 40), _ev("k", 45, 100),
              _ev("step", 0, 100, device=False),
              _ev("aten::copy_", 8, 35, device=False)]
    gaps = dict(devtrace.idle_gaps(events, 0, 100 * MS))
    # 10..30 opens inside aten::copy_; 40..45 inside step only
    assert gaps == {"aten::copy_": 0.02, "step": 0.005}


class _Run:
    def __init__(self, events, work, config):
        self.events = events
        self.window = harness.Window({}, work, 0, 100 * MS, 1)
        self.config = config


def _config():
    return harness.load_json(harness.BENCH_DIR / "configs"
                             / "cfg-cifar10.json")


def test_idle_reader():
    read = harness.load_reader("device_idle_pct.cfg_sample")
    run = _Run([_ev("k", 0, 25), _ev("k", 50, 75)], {}, _config())
    assert read(run, {}) == pytest.approx(50.0)


def test_mfu_reader():
    from benchmark.counts import flops

    read = harness.load_reader("mfu_pct.cfg_sample")
    config = _config()
    work = {"kind": "sample", "model_calls": 10, "batch": 160}
    want = 100 * 10 * 160 * flops.per_item(config, "sample") / (0.1 * 989e12)
    assert read(_Run([], work, config), {}) == pytest.approx(want)
    assert read(_Run([], {"model_calls": 0}, config), {}) is None


def test_attention_roofline_reader_reads_only_its_kernels():
    from benchmark.counts import attention

    read = harness.load_reader("attn_roofline_pct.cfg_sample")
    config = _config()
    work = {"kind": "sample", "model_calls": 2, "batch": 160}
    events = [_ev("void attention_fwd_mma_kernel<bf16, 16, false>", 0, 4),
              _ev("void attention_fwd_wgmma_kernel<bf16, 32, false>", 4, 5),
              _ev("sm90_xmma_fprop_implicit_gemm", 5, 50)]
    bound = attention.bound_s(config["model"], 160, "bfloat16", False,
                              harness.peaks())
    assert read(_Run(events, work, config), {}) == \
        pytest.approx(100 * 2 * bound / 0.005)
    no_kernel = _Run(events[2:], work, config)
    assert read(no_kernel, {}) is None
