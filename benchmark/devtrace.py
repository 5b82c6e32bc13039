"""The traced run's device trace, reduced to what the readers need.

`Profiler` records the window with `torch.profiler`, CUDA activity alone
(the card's kernels, copies and sets, and the host's CUDA runtime calls;
no shapes, no stacks, nothing written to disk): recording every host
operation as well slows a host-bound cell by a quarter and more, which
would show as idle time that the untraced run does not have. `events`
turns the profiler's raw events into `Event`s on the system clock (ns),
which the drivers' window bounds (`time.time_ns()`) share; the program's
`record_function` ranges, which the profiler also dates on the card, are
left out. Then:

  - `busy_ns`: the union of the device's kernel, copy and set intervals
    inside the window, as `profile_loop.busy_us` of the program counts it:
    work that overlaps is counted once;
  - `device_ops`: device time by operation name, the longest first;
  - `idle_gaps`: the device's idle gaps inside the window, summed by what
    the host was doing when each began (the innermost CUDA runtime call
    open at that moment, or "host: no op": Python, or host work that
    calls no CUDA).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Iterable

NAME_CHARS = 120  # a breakdown entry's name is cut to this length


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    device: bool          # True: ran on the card (kernel, copy, set)
    start_ns: int
    end_ns: int


class Profiler:
    """torch.profiler over the window, CUDA activity alone (host activity
    on a machine without a card, where nothing runs on a device)."""

    def __init__(self):
        import torch

        acts = torch.profiler.ProfilerActivity
        self._prof = torch.profiler.profile(activities=[
            acts.CUDA if torch.cuda.is_available() else acts.CPU])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)

    def events(self) -> list[Event]:
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.is_user_annotation():
                continue
            start = e.start_ns()
            out.append(Event(e.name(), e.device_type() == cuda, start,
                             start + e.duration_ns()))
        return out


def clip(events: Iterable[Event], start_ns: int, end_ns: int,
         device: bool = True) -> list[tuple[int, int, str]]:
    """(start, end, name) of the device (or host) events, cut to the
    window; events wholly outside it are dropped."""
    out = []
    for e in events:
        if e.device == device and e.end_ns > start_ns and e.start_ns < end_ns:
            out.append((max(e.start_ns, start_ns), min(e.end_ns, end_ns),
                        e.name))
    return out


def union(spans: Iterable[tuple[int, int]]) -> list[tuple[int, int]]:
    """The sorted union of [start, end) intervals."""
    merged: list[list[int]] = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def busy_ns(events: Iterable[Event], start_ns: int, end_ns: int) -> int:
    """Length of the union of the device's intervals inside the window."""
    return sum(hi - lo for lo, hi in
               union((s, e) for s, e, _ in clip(events, start_ns, end_ns)))


def device_ops(events: Iterable[Event], start_ns: int, end_ns: int,
               top: int = 10) -> list[list]:
    """[[name, seconds], ...]: device time by operation name inside the
    window, the `top` longest."""
    total: dict[str, int] = collections.Counter()
    for s, e, name in clip(events, start_ns, end_ns):
        total[name[:NAME_CHARS]] += e - s
    return [[n, t / 1e9] for n, t in
            sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(events: Iterable[Event], start_ns: int, end_ns: int,
              top: int = 10, walk: int = 512) -> list[list]:
    """[[what the host was doing, seconds], ...]: the device's idle time
    inside the window, summed by the innermost host event open at the
    start of each gap (among the `walk` host events that began last
    before it), the `top` largest."""
    events = list(events)
    busy = union((s, e) for s, e, _ in clip(events, start_ns, end_ns))
    gaps, t = [], start_ns
    for lo, hi in busy:
        if lo > t:
            gaps.append((t, lo))
        t = max(t, hi)
    if t < end_ns:
        gaps.append((t, end_ns))
    host = sorted((e.start_ns, e.end_ns, e.name) for e in events
                  if not e.device and e.end_ns > start_ns
                  and e.start_ns < end_ns)
    starts = [h[0] for h in host]
    total: dict[str, int] = collections.Counter()
    for lo, hi in gaps:
        label = "host: no op"
        i = bisect.bisect_right(starts, lo)
        for j in range(i - 1, max(i - 1 - walk, -1), -1):
            if host[j][1] > lo:
                label = host[j][2][:NAME_CHARS]
                break
        total[label] += hi - lo
    return [[n, t / 1e9] for n, t in
            sorted(total.items(), key=lambda kv: -kv[1])[:top]]
