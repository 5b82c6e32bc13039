"""Readers of the per-layer metrics, one file per metric or per stem
(`<stem>.<suffix>` shares `<stem>.py`). Each has read(run, metric) ->
float or None: None where the traced window holds nothing to read."""
