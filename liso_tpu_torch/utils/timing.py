"""Timing utilities (a copy of liso_tpu/utils/timing.py).

Behavioral reference: liso/utils/timing_utils.py (@timeit decorator) +
the per-step fwd/bwd/dataloading wall-clock scalars of
liso/kabsch/liso_cli.py:621-633. The JAX package's `jax_trace` context has
no counterpart here: the port's trace is `--profile`
(`cli.common.run_maybe_profiled`, torch.profiler).
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict


def timeit(fn):
    """Accumulates wall time per function name in timeit.stats."""

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        timeit.stats[fn.__qualname__] += time.perf_counter() - t0
        timeit.calls[fn.__qualname__] += 1
        return out

    return wrapper


timeit.stats = defaultdict(float)
timeit.calls = defaultdict(int)


class StepTimer:
    """Per-step section timing -> dict of scalars for TB
    (liso_cli.py timings = fwd/bwd/dataloading)."""

    def __init__(self):
        self.sections: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        yield
        self.sections[f"timing/{name}_s"] = time.perf_counter() - t0

    def pop(self) -> Dict[str, float]:
        out, self.sections = self.sections, {}
        return out
