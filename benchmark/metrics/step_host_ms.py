"""The host's time of one sampler step, in ms: the median host duration
of the program's `sampler/step` spans that begin in the window (Python,
the model's dispatch and its launches, and any wait for the card)."""

from benchmark import spans


def read(run, metric):
    return spans.median([(r["end_ns"] - r["start_ns"]) / 1e6 for r in
                         spans.in_window(run, "sampler/step")])
