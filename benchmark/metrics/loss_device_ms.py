"""The card's time of the training step's loss terms' forward, in ms: the
median `device_ms` of the program's `train/loss` spans that begin in the
window (their backward lies inside `train/backward`)."""

from benchmark import spans


def read(run, metric):
    return spans.median([r["device_ms"] for r in
                         spans.in_window(run, "train/loss")])
