"""The hand-written attention kernels' share of their roofline, in %: the
sum over the window's launches of max(operations ÷ peak FLOP/s, bytes ÷
peak bytes/s) (counts/attention.py, from the reference's shapes × the
model calls completed), over the summed device time of the kernels whose
names hold a fragment of attn_roofline_pct.json (forward and backward
together in a training cell)."""

from pathlib import Path

from benchmark import devtrace, harness
from benchmark.counts import attention

DTYPES = {"bf16": "bfloat16", "fp16": "float16", "fp32": "float32"}
KERNELS = harness.load_json(Path(__file__).with_suffix(".json"))["kernels"]


def read(run, metric):
    w = run.window
    kernel_ns = sum(e - s for s, e, name in
                    devtrace.clip(run.events, w.start_ns, w.end_ns)
                    if any(k in name for k in KERNELS))
    calls = w.work.get("model_calls", 0)
    if kernel_ns <= 0 or not calls:
        return None
    bound = attention.bound_s(run.config["model"], w.work["batch"],
                              DTYPES[run.config["precision"]],
                              w.work["kind"] == "train", harness.peaks())
    return 100.0 * calls * bound / (kernel_ns / 1e9)
