"""The card's time of the training step's update, in ms: the median
`device_ms` of the program's `train/update` spans that begin in the window
(the gated gradients, clip, AdamW, the gated blend and the EMA)."""

from benchmark import spans


def read(run, metric):
    return spans.median([r["device_ms"] for r in
                         spans.in_window(run, "train/update")])
