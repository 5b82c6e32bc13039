"""Tracing and timing hooks.

Counterpart of `hybrid_diffusion_tpu/utils/profiling.py` (:32-65):

  - `profile_trace(dir)` wraps a region in a `torch.profiler` trace of the
    host and the card, written as a Chrome trace into `dir` (enabled
    product-wide by HDT_PROFILE=<dir>; a no-op otherwise, so the hot loops
    carry no cost by default);
  - `timed_block(name)` is a wall-clock print that synchronizes the card
    before it reads the clock, so it times the work and not its dispatch.

The port's span recorder:

  - `span(name, device=False, request=None, **attrs)` marks one layer's
    work (the Enhancer's request path, each sampler step, the train step's
    phases). It records only while a `torch.profiler` session records (the
    benchmark's traced window, `profile_trace`, the profile tools); at any
    other time it returns one shared no-op object, so a call outside a
    profiler costs one flag check. A recorded span holds an id, its name,
    its parent's id (the innermost span open on this thread), a request id
    (given, or the nearest ancestor's), its host start and end on
    `time.time_ns()` (the clock that kineto dates its events on, so a span
    can be laid over a device trace), and its attrs. It also enters
    `record_function(name)`, so its range shows in the profiler's trace. A
    `device=True` span records a CUDA event on the current stream at entry
    and at exit, with no synchronize. Records are kept in memory, at most
    CAP of them; those past the cap are counted by `dropped()`;
  - `spans()` returns the records with `device_ms` resolved (after the
    caller synchronized the card), `clear()` empties them;
  - `busy_us(prof)` is the device's busy time in a profiler's trace: the
    union of its kernel, copy and set intervals, so work that overlaps is
    counted once.

Usage:
    with profile_trace():            # respects HDT_PROFILE
        out = sampler(batch, generator)

    with timed_block("sampling") as tb:
        out = tb.block(sampler(batch, generator))

    with span("sampler/step", device=True, t=t):
        eps = model(x, t)
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Iterator, Optional

import torch
from torch.autograd import profiler as _profiler

# The most span records kept; those past it are counted, not kept.
CAP = 1 << 16


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """torch.profiler trace of the enclosed region; no-op unless enabled.

    trace_dir: output directory; defaults to $HDT_PROFILE (the hook is
    disabled when neither is set). Each region writes its own
    trace_<pid>_<n>.json.
    """
    trace_dir = trace_dir or os.environ.get("HDT_PROFILE")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        _synchronize()
    n = len([f for f in os.listdir(trace_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace_{os.getpid()}_{n}.json"))


class _Timer:
    def __init__(self, name: str):
        self.name = name
        self.start = time.perf_counter()
        self.elapsed: Optional[float] = None

    def block(self, x):
        """Wait until the card has finished the queued work; returns x."""
        _synchronize()
        return x


@contextlib.contextmanager
def timed_block(name: str, verbose: bool = True) -> Iterator[_Timer]:
    _synchronize()
    t = _Timer(name)
    try:
        yield t
    finally:
        _synchronize()
        t.elapsed = time.perf_counter() - t.start
        if verbose:
            print(f"[{name}] time cost: {t.elapsed:.3f}s")


class _Off:
    """What `span` returns outside a profiler: enters and leaves at no cost."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()
_ids = itertools.count(1)
_open = threading.local()       # .stack: this thread's open spans
_records: list = []
_dropped = 0


class _Span:
    __slots__ = ("id", "name", "parent", "request", "start_ns", "end_ns",
                 "attrs", "device_ms", "_range", "_events")

    def __init__(self, name: str, device: bool, request, attrs: dict):
        self.name, self.request, self.attrs = name, request, attrs
        self.device_ms: Optional[float] = None
        self._events = None
        if device and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent else None
        if self.request is None and parent is not None:
            self.request = parent.request
        stack.append(self)
        self._range = _profiler.record_function(self.name)
        self._range.__enter__()
        if self._events:
            self._events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        self.end_ns = time.time_ns()
        if self._events:
            self._events[1].record()
        self._range.__exit__(*exc)
        self._range = None
        _open.stack.pop()
        if len(_records) < CAP:
            _records.append(self)
        else:
            _dropped += 1
        return None


def span(name: str, device: bool = False, request=None, **attrs):
    """A context manager that records one span while a profiler records
    (see the module's docstring), and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device, request, attrs)


def spans() -> list[dict]:
    """The kept records, in the order they were opened: {id, name, parent,
    request, start_ns, end_ns, attrs, device_ms (None for a host span)}.
    Raises RuntimeError where a device span's work has not finished on the
    card: synchronize first."""
    for r in _records:
        if r._events is not None:
            start, end = r._events
            if not end.query():
                raise RuntimeError(f"span {r.name!r} has work queued on the "
                                   "card: synchronize before spans()")
            r.device_ms = start.elapsed_time(end)
            r._events = None
    return [{"id": r.id, "name": r.name, "parent": r.parent,
             "request": r.request, "start_ns": r.start_ns,
             "end_ns": r.end_ns, "attrs": r.attrs, "device_ms": r.device_ms}
            for r in sorted(_records, key=lambda r: r.id)]


def dropped() -> int:
    """Spans closed after CAP records were kept, since the last clear()."""
    return _dropped


def clear() -> None:
    global _dropped
    _records.clear()
    _dropped = 0


def busy_us(prof) -> float:
    """Length, in µs, of the union of the device's kernel, copy and set
    intervals in a finished `torch.profiler.profile` (the ranges of
    `record_function` that the profiler also dates on the card are left
    out)."""
    intervals = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.is_user_annotation)
    total, end = 0.0, float("-inf")
    for lo, hi in intervals:
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total
