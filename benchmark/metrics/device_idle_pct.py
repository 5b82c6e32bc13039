"""The device's idle share of the traced window, in %: 100 × (1 − the
union of its kernel, copy and set intervals ÷ the window)."""

from benchmark import devtrace


def read(run, metric):
    w = run.window
    span = w.end_ns - w.start_ns
    if span <= 0:
        return None
    return 100.0 * (1.0 - devtrace.busy_ns(run.events, w.start_ns,
                                           w.end_ns) / span)
