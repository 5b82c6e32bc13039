"""The whole step's share of the card's peak, in %: the model FLOPs of the
window's work, counted over the plain reference (counts/flops.py), over
the window's seconds × the peak rate of the configuration's precision."""

from benchmark import harness
from benchmark.counts import flops

DTYPES = {"bf16": "bfloat16", "fp16": "float16", "fp32": "float32"}


def read(run, metric):
    w = run.window
    seconds = (w.end_ns - w.start_ns) / 1e9
    if not w.work.get("model_calls") or seconds <= 0:
        return None
    peak = harness.peaks()["flops_per_s"][DTYPES[run.config["precision"]]]
    return 100.0 * flops.window_flops(run.config, w.work) / (seconds * peak)
