"""Tracing and timing hooks.

Counterpart of `hybrid_diffusion_tpu/utils/profiling.py` (:32-65):

  - `profile_trace(dir)` wraps a region in a `torch.profiler` trace of the
    host and the card, written as a Chrome trace into `dir` (enabled
    product-wide by HDT_PROFILE=<dir>; a no-op otherwise, so the hot loops
    carry no cost by default);
  - `timed_block(name)` is a wall-clock print that synchronizes the card
    before it reads the clock, so it times the work and not its dispatch.

Usage:
    with profile_trace():            # respects HDT_PROFILE
        out = sampler(batch, generator)

    with timed_block("sampling") as tb:
        out = tb.block(sampler(batch, generator))
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


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
