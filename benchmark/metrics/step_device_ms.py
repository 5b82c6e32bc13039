"""The card's time of one sampler step, in ms: the median, over the
program's `sampler/step` spans that begin in the window, of the time
between the CUDA events the span records at its entry and exit (the
guided model call and the update, without the host's gaps before it)."""

from benchmark import spans


def read(run, metric):
    return spans.median([r["device_ms"] for r in
                         spans.in_window(run, "sampler/step")])
