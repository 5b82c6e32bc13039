"""The device's idle time while the host resizes, in % of the window:
100 × the length of (the device's idle time ∩ the union of the program's
`enhance/resize_in` and `enhance/resize_out` spans) ÷ the window. The
idle time is the window less the union of the device's kernel, copy and
set intervals (devtrace)."""

from benchmark import devtrace, spans

RESIZES = ("enhance/resize_in", "enhance/resize_out")


def intersection_ns(a: list[tuple[int, int]],
                    b: list[tuple[int, int]]) -> int:
    """Length of the intersection of two sorted unions of disjoint
    [start, end) intervals (devtrace.union's)."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run, metric):
    w = run.window
    if w.end_ns <= w.start_ns:
        return None
    resize = devtrace.union(
        (max(r["start_ns"], w.start_ns), min(r["end_ns"], w.end_ns))
        for r in spans.program_spans()
        if r["name"] in RESIZES and r["end_ns"] > w.start_ns
        and r["start_ns"] < w.end_ns)
    if not resize:
        return None
    busy = devtrace.union((s, e) for s, e, _ in
                          devtrace.clip(run.events, w.start_ns, w.end_ns))
    idle = sum(hi - lo for lo, hi in resize) - intersection_ns(resize, busy)
    return 100.0 * idle / (w.end_ns - w.start_ns)
