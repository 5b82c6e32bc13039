"""The program's own spans inside the traced window, for the readers.

The program records spans (`utils/profiling.py::span` of the program)
only while a profiler records, so only the `--trace 1` run has any. Each
record carries its host start and end on `time.time_ns()`, the clock of
the window's bounds and of the device trace's events (devtrace.Event),
and, for a span that timed the card, `device_ms` between CUDA events at
its entry and exit. A program without the recorder (an older checkout)
gives no records, and the readers then read nothing.
"""

from __future__ import annotations

import importlib
import statistics
from typing import Optional

RECORDER = "hybrid_diffusion_tpu_torch.utils.profiling"


def program_spans() -> list[dict]:
    """Every record the program kept ([] where it keeps none). The cell's
    set-up has imported the program by the time a reader runs."""
    try:
        recorder = importlib.import_module(RECORDER)
    except ImportError:
        return []
    read = getattr(recorder, "spans", None)
    return read() if read is not None else []


def in_window(run, name: str) -> list[dict]:
    """The records named `name` whose host start lies in the window."""
    w = run.window
    return [r for r in program_spans()
            if r["name"] == name and w.start_ns <= r["start_ns"] < w.end_ns]


def median(values: list) -> Optional[float]:
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None
