"""Device and host time of a function on the card."""

from __future__ import annotations

import statistics
import time

import torch

_MAX_SLEEP_CYCLES = 1 << 34


def device_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over `reps` of the mean device time of `inner` back-to-back
    calls of `fn`, from CUDA events; warm (3 calls first).

    Each sample first queues a sleep kernel on the card, long enough for the
    host to queue all `inner` calls behind it, so that the events time the
    card's work and not the host's launch rate (a kernel of tens of
    microseconds is shorter than its Python wrapper's host time). A sample
    whose start event had already passed when the host was done queueing is
    taken again with a sleep twice as long.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 20
    samples = []
    while len(samples) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            samples.append(start.elapsed_time(end) / inner)
        elif cycles < _MAX_SLEEP_CYCLES:
            cycles *= 2
        else:
            raise RuntimeError("the host could not queue the timed calls "
                               "ahead of the card")
    return statistics.median(samples)


def host_ms(fn, calls: int = 100) -> float:
    """Mean host time of one call of `fn` (what it costs the CPU to queue
    its work), over `calls` calls without synchronising; warm."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e3
