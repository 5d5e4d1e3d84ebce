"""Spans and counters of the program's layers, on the host clock and, while
a torch profiler records, on the profiler's clock too.

`span(name, step=None)` times a block:

    with trace.span("det.loss") as s:
        losses = ...
    s.seconds  # the block's host seconds, once it has closed

With no profiler recording, a span reads `time.perf_counter_ns()` twice and
adds its duration to the name's totals (calls, nanoseconds) and to a ring
of the name's last `RING` durations. While a `torch.profiler` records, the
span also opens `record_function(name)` (the step number as the range's
args where `step` is given), so the range sits in the profiler's trace
beside the operators and kernels launched inside it; its duration then
goes into neither the totals nor the ring, because recording slows the
host. Either way the span's own seconds are kept, and the name's last
duration (`stats(name)["last_ms"]`) is what a logger reads for the step
that just ran.

Names are dotted and say the layer first (`stream.flow`, `det.loss`,
`data.wait`). A name is opened on one thread: the loader's producer thread
has its own names (`data.produce`), so its durations never share a ring
with the consumer's. A span only times: it neither synchronises the device
nor reads a device value.

`count(name, n)` adds to a cumulative counter and to a ring of the
name's last `RING` increments; like a span's duration, a count made while a
profiler records goes into neither, so a counter and a span of the same
calls (`det.points_pasted`, `det.paste`) stay comparable. `stats`,
`counter`, `counter_ring` and `snapshot` read; `reset` clears everything
(tests).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

_clock = time.perf_counter_ns
RING = 256  # durations kept per name, for the mean over the recent ones


class _Stat:
    """One name's untraced calls and nanoseconds, its ring of recent
    untraced durations, and its last duration (traced or not). One thread
    writes a name (the module's docstring), so its updates need no lock; a
    reader on another thread sees each value whole."""

    __slots__ = ("calls", "total_ns", "ring", "last_ns")

    def __init__(self):
        self.calls = 0
        self.total_ns = 0
        self.ring = deque(maxlen=RING)
        self.last_ns = 0


_stats: Dict[str, _Stat] = {}
_counters: Dict[str, int] = {}
_counter_rings: Dict[str, deque] = {}
_counter_lock = threading.Lock()


class span:
    """Times the block it wraps (see the module's docstring). `seconds`
    holds the block's host seconds once the block has closed."""

    __slots__ = ("name", "step", "seconds", "_range", "_t0")

    def __init__(self, name: str, step: Optional[int] = None):
        self.name = name
        self.step = step
        self.seconds: Optional[float] = None

    def __enter__(self):
        if _profiler_enabled():
            self._range = record_function(
                self.name, None if self.step is None else str(self.step))
            self._range.__enter__()
        else:
            self._range = None
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = _clock() - self._t0
        self.seconds = dt * 1e-9
        st = _stats.get(self.name) or _stats.setdefault(self.name, _Stat())
        st.last_ns = dt
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        elif not _profiler_enabled():  # else a profiler started inside
            st.calls += 1
            st.total_ns += dt
            st.ring.append(dt)
        return False


def _copy(ring: deque) -> tuple:
    """The ring's durations, oldest first; retried if its writer appends
    while they are copied."""
    while True:
        try:
            return tuple(ring)
        except RuntimeError:  # deque mutated during iteration
            continue


def count(name: str, n: int = 1) -> None:
    """Add `n` to the cumulative counter `name` and to its ring (nothing
    while a profiler records)."""
    if _profiler_enabled():
        return
    with _counter_lock:
        _counters[name] = _counters.get(name, 0) + int(n)
        ring = _counter_rings.get(name)
        if ring is None:
            ring = _counter_rings[name] = deque(maxlen=RING)
        ring.append(int(n))


def stats(name: str) -> Optional[dict]:
    """A span's untraced calls, their total ms and the mean ms over the
    ring (None while the ring is empty), the ring's durations in ms (oldest
    first) and the last duration in ms, traced or not. None for a name no
    span has closed under."""
    st = _stats.get(name)
    if st is None:
        return None
    calls, total_ns, last_ns = st.calls, st.total_ns, st.last_ns
    ring = [d * 1e-6 for d in _copy(st.ring)]
    return {"calls": calls, "total_ms": total_ns * 1e-6,
            "mean_ms": sum(ring) / len(ring) if ring else None,
            "ring_ms": ring, "last_ms": last_ns * 1e-6}


def counter(name: str) -> int:
    """The counter's value (0 for a name never counted)."""
    return _counters.get(name, 0)


def counter_ring(name: str) -> list:
    """The counter's last `RING` increments, oldest first (empty for a name
    never counted)."""
    with _counter_lock:
        return list(_counter_rings.get(name, ()))


def snapshot() -> dict:
    """Every span's calls, total ms and ring mean ms, and every counter,
    for a logger."""
    spans = {}
    for name in list(_stats):
        s = stats(name)
        spans[name] = {k: s[k] for k in ("calls", "total_ms", "mean_ms")}
    with _counter_lock:
        counters = dict(_counters)
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Forget every span and counter."""
    _stats.clear()
    with _counter_lock:
        _counters.clear()
        _counter_rings.clear()
