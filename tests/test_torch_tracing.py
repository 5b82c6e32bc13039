"""The port's span recorder (utils/profiling.py::span) on the CPU: silent
outside a profiler, and inside one the names, parents and request ids of
the Enhancer's request path and every sampler step, on the clock of the
profiler's own events; exceptions close spans, the cap counts what it
drops, and the shared busy share counts overlapping work once."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_parity import one_torch_thread  # noqa: F401

from hybrid_diffusion_tpu_torch.cfg.sampler import cfg_ddpm_sample
from hybrid_diffusion_tpu_torch.config import Config
from hybrid_diffusion_tpu_torch.diffusion.schedule import linear_beta_schedule
from hybrid_diffusion_tpu_torch.serve import Enhancer
from hybrid_diffusion_tpu_torch.train.loop import make_sampler
from hybrid_diffusion_tpu_torch.utils import profiling
from hybrid_diffusion_tpu_torch.utils.profiling import (busy_us, clear,
                                                        dropped, span, spans)

T, SIZE, BATCH = 8, 8, 4


@pytest.fixture(autouse=True)
def empty_store():
    clear()
    yield
    clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _stub_model(x6, t, context_zero=True):
    """ε of a denoiser that knows nothing: a fixed function of its input."""
    return 0.1 * x6[..., 3:] + 0.01 * x6[..., :3]


def _enhancer(sampler: str) -> Enhancer:
    """An Enhancer on the CPU whose device call samples with the stub
    denoiser: the request path's own code, with no weights."""
    config = Config(T=T, img_size=SIZE, bf16=False, ddim_step=4,
                    sampler="dpm++2m" if sampler == "dpm++2m" else "",
                    ddim=sampler == "ddim")
    enh = Enhancer.__new__(Enhancer)
    enh.device, enh.config = torch.device("cpu"), config
    enh.max_batch, enh.size = BATCH, SIZE
    enh._sample = make_sampler(config, _stub_model, quantize_uint8=True)
    enh._generator = torch.Generator().manual_seed(0)
    enh.device_calls = enh.requests = 0
    return enh


def _images(n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (SIZE + 3 * i, SIZE + 1, 3), np.uint8)
            for i in range(n)]


def test_outside_a_profiler_span_records_nothing(monkeypatch):
    ranges = []
    monkeypatch.setattr(profiling._profiler, "record_function",
                        lambda name: ranges.append(name))
    assert span("a") is span("b", device=True, request=3, t=1)
    enh = _enhancer("dpm++2m")
    assert len(enh.enhance(_images(3))) == 3
    with pytest.raises(ValueError):
        with span("x"):
            raise ValueError
    assert spans() == [] and dropped() == 0 and ranges == []


@pytest.mark.parametrize("sampler,steps", [("dpm++2m", 4), ("ddim", 4),
                                           ("ddpm", T)])
def test_enhance_spans_nest_with_inherited_request_ids(sampler, steps):
    enh = _enhancer(sampler)
    enh.enhance(_images(2))                 # request 1, untraced
    with _cpu_profile() as prof:
        out = enh.enhance(_images(BATCH + 1))   # request 2: two calls
    assert [o.shape for o in out] == [im.shape for im in _images(BATCH + 1)]
    recs = spans()
    by_id = {r["id"]: r for r in recs}
    names = [r["name"] for r in recs]
    call = ["enhance/call", "enhance/h2d", "enhance/sample"] + \
        ["sampler/step"] * steps + ["enhance/d2h"]
    assert names == ["enhance", "enhance/resize_in", *call, *call,
                     "enhance/resize_out"]
    root = recs[0]
    assert root["parent"] is None and root["attrs"] == {"images": BATCH + 1}
    assert all(r["request"] == 2 for r in recs)
    parent = lambda r: by_id[r["parent"]]["name"]
    for r in recs[1:]:
        want = {"enhance/h2d": "enhance/call", "enhance/sample": "enhance/call",
                "enhance/d2h": "enhance/call",
                "sampler/step": "enhance/sample"}.get(r["name"], "enhance")
        assert parent(r) == want
        assert root["start_ns"] <= r["start_ns"] <= r["end_ns"] \
            <= root["end_ns"]
    calls = [r["attrs"] for r in recs if r["name"] == "enhance/call"]
    assert calls == [{"rows": BATCH, "padded": 0},
                     {"rows": 1, "padded": BATCH - 1}]
    steps_t = [r["attrs"]["t"] for r in recs if r["name"] == "sampler/step"]
    assert steps_t[:steps] == sorted(steps_t[:steps], reverse=True)
    assert all(r["device_ms"] is None for r in recs)   # no card here
    annotated = {e.name for e in prof.events()}
    assert {"enhance", "enhance/sample", "sampler/step"} <= annotated


def test_cfg_sampler_step_spans_under_a_caller_span():
    sched = linear_beta_schedule(1e-4, 0.02, T)
    labels = torch.tensor([1, 2])
    gen = torch.Generator().manual_seed(0)
    model = lambda x, t, lab: 0.1 * x
    with _cpu_profile():
        with span("grid", request="g1"):
            cfg_ddpm_sample(model, sched, labels, gen, image_size=4, w=1.8)
    recs = spans()
    assert [r["attrs"]["t"] for r in recs[1:]] == list(range(T - 1, -1, -1))
    assert all(r["parent"] == recs[0]["id"] and r["request"] == "g1"
               for r in recs[1:])


def test_a_span_brackets_its_ops_kineto_event_on_the_same_clock():
    a = torch.randn(256, 256)
    with _cpu_profile() as prof:
        with span("mm"):
            torch.mm(a, a)
    (rec,) = spans()
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    start = mm[0].start_ns()
    assert rec["start_ns"] <= start
    assert start + mm[0].duration_ns() <= rec["end_ns"]


def test_an_exception_closes_the_span_and_propagates():
    with _cpu_profile():
        with pytest.raises(KeyError):
            with span("outer", request=5):
                with span("inner"):
                    raise KeyError("stop")
        with span("after"):
            pass
    outer, inner, after = spans()
    assert inner["parent"] == outer["id"] and inner["request"] == 5
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= outer["end_ns"]
    assert after["parent"] is None and after["request"] is None


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 3)
    with _cpu_profile():
        for i in range(5):
            with span("s", i=i):
                pass
    assert [r["attrs"]["i"] for r in spans()] == [0, 1, 2]
    assert dropped() == 2
    clear()
    assert spans() == [] and dropped() == 0


def test_spans_refuses_work_still_queued_on_the_card():
    class Pending:
        def query(self):
            return False

    with _cpu_profile():
        with span("sampler/step", device=True):
            pass
    profiling._records[0]._events = (Pending(), Pending())
    with pytest.raises(RuntimeError, match="synchronize"):
        spans()


def test_busy_us_counts_overlapping_device_work_once():
    class Range:
        def __init__(self, start, end):
            self.start, self.end = start, end

    class Event:
        def __init__(self, lo, hi, cuda=True, annotation=False):
            self.time_range = Range(lo, hi)
            self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                                else torch.autograd.DeviceType.CPU)
            self.is_user_annotation = annotation

    class Prof:
        def events(self):
            return [Event(0, 10), Event(5, 15), Event(20, 30),
                    Event(0, 100, cuda=False), Event(0, 50, annotation=True)]

    assert busy_us(Prof()) == 25.0
