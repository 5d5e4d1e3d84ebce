"""What the per-layer readers of the program's own spans and counters share
(`liso_tpu_torch/utils/trace.py`, which the program opens where the work
happens). A program without that module, or without the span, gives
nothing to read: the reader returns None and the metric stays out of the
line."""
from __future__ import annotations


def tracer():
    """The program's span module, or None where the program has none."""
    try:
        from liso_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def host_ms(span: str):
    """Host ms per call of the program's span `span`: the mean over its ring,
    the last 256 calls made with no profiler recording (the window's)."""
    trace = tracer()
    st = trace.stats(span) if trace else None
    return st["mean_ms"] if st else None


def device_ms(record, span: str):
    """Device ms per traced step in the kernels, copies and sets launched
    while the program's span `span` was open (the launch's host ranges)."""
    trace = tracer()
    tv = record.trace
    if tv is None or trace is None or trace.stats(span) is None:
        return None
    return tv.device_s(lambda stack: span in stack) / tv.steps * 1e3
