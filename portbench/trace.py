"""The traced sub-windows: `torch.profiler` over a few steps, read back from
its Chrome trace. A first pass records the device alone: its busy share
and its longest operations. A second records host operators too, which
slows the host, so its idle gaps only say what the host was doing.

Every device event (kernel, copy, set) is tied through its correlation id
to the host launch that enqueued it, and so to the host ranges open at
that launch: the benchmark's own spans (`pb.*`, opened around each stage
and, in a traced run, around each hand-written kernel's op) and PyTorch's
operators (`aten::convolution`, ...). From that the readers take a
layer's device time by the op and not by a kernel's name.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

WINDOW = "pb.window"
PROBES = 8  # instants at which an idle gap asks what the host is doing
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class DeviceEvent:
    name: str
    ts: float  # us
    dur: float  # us
    stack: Tuple[str, ...]  # host ranges open at its launch, outermost first


@dataclass
class TraceView:
    steps: int
    window_us: Tuple[float, float]
    events: List[DeviceEvent]
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # (label, us)

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) * 1e-6

    def busy_s(self) -> float:
        """Seconds of the window in which some device event ran (the union
        of their intervals)."""
        lo, hi = self.window_us
        return _union_s([DeviceEvent(e.name, max(e.ts, lo),
                                     min(e.ts + e.dur, hi) - max(e.ts, lo), ())
                         for e in self.events])

    def device_s(self, pred) -> float:
        """Device seconds of the events whose launch stack satisfies
        `pred(stack)`."""
        return sum(e.dur for e in self.events if pred(e.stack)) * 1e-6

    def top_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for e in self.events:
            by[e.name] += e.dur * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for label, us in self.gaps:
            by[label] += us * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def device_pass(step, n_steps: int, tmpdir) -> dict:
    """`step()` n_steps times with the profiler recording the device alone
    (no host operators, whose recording would slow the host and so widen
    the device's idle gaps): the union of the device events' intervals
    (busy_s) over the host clock's window from a synchronise to a
    synchronise (window_s), and the device operations that took most
    time."""
    import time

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = [DeviceEvent(e["name"], e["ts"], e.get("dur", 0.0), ())
              for e in _export(prof, tmpdir) if e.get("cat") in DEVICE_CATS]
    view = TraceView(steps=n_steps, window_us=(0.0, 0.0), events=events)
    return {"busy_s": _union_s(events), "window_s": window_s,
            "device_ops": view.top_ops()}


def profile_steps(step, n_steps: int, tmpdir) -> TraceView:
    """Run `step()` n_steps times under the profiler (host operators and
    device), inside one `pb.window` range that ends after a device
    synchronise, and read the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    sync()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            for _ in range(n_steps):
                step()
            sync()
    return read_trace(_export(prof, tmpdir), n_steps)


def _export(prof, tmpdir) -> list:
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union_s(events) -> float:
    busy, end = 0.0, -float("inf")
    for a, b in sorted((e.ts, e.ts + e.dur) for e in events):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy * 1e-6


def _stacks(host: list, launches: list) -> Dict[int, Tuple[Tuple[str, ...], float]]:
    """correlation id -> (names of the host ranges open at the launch,
    launch time), per thread by a sweep over ranges sorted by start."""
    out = {}
    by_tid = defaultdict(list)
    for e in host:
        by_tid[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0.0),
                                 0, e["name"]))
    for e in launches:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            by_tid[e["tid"]].append((e["ts"], e["ts"], 1, corr))
    for items in by_tid.values():
        items.sort(key=lambda r: (r[0], r[2], -r[1]))
        stack: List[Tuple[float, str]] = []
        for start, end, kind, val in items:
            while stack and stack[-1][0] < start:
                stack.pop()
            if kind == 0:
                stack.append((end, val))
            else:
                out[val] = (tuple(name for _, name in stack), start)
    return out


def read_trace(data, n_steps: int) -> TraceView:
    events = data["traceEvents"] if isinstance(data, dict) else data
    host, launches, device = [], [], []
    window = None
    for e in events:
        cat = e.get("cat")
        if cat in ("cpu_op", "user_annotation"):
            host.append(e)
            if e.get("name") == WINDOW and window is None:
                window = (e["ts"], e["ts"] + e["dur"])
        elif cat in LAUNCH_CATS:
            launches.append(e)
        elif cat in DEVICE_CATS:
            device.append(e)
    if window is None:
        raise RuntimeError("the trace holds no pb.window range")
    stacks = _stacks(host, launches)
    out = []
    for e in device:
        corr = e.get("args", {}).get("correlation")
        stack = stacks.get(corr, ((), None))[0]
        if e["ts"] + e.get("dur", 0.0) < window[0] or e["ts"] > window[1]:
            continue
        out.append(DeviceEvent(e.get("name", "?"), e["ts"], e.get("dur", 0.0),
                               stack))
    view = TraceView(steps=n_steps, window_us=window, events=out)
    view.gaps = _idle_gaps(view, host)
    return view


def _idle_gaps(view: TraceView, host: list) -> List[Tuple[str, float]]:
    """Every stretch of the window with no device event, labelled by what
    the thread that opened the window was doing meanwhile: its innermost
    benchmark span and innermost operator."""
    lo, hi = view.window_us
    main_tid = None
    for e in host:
        if e.get("name") == WINDOW:
            main_tid = e["tid"]
            break
    ranges = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
                    for e in host if e["tid"] == main_tid)
    ivs = sorted((e.ts, e.ts + e.dur) for e in view.events)
    gaps, end = [], lo
    for a, b in ivs + [(hi, hi)]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    # what the host was doing over each gap: the gap's time split evenly
    # over PROBES instants, each labelled by the innermost benchmark span
    # and operator open on the window's thread then
    probes = []
    for a, b in gaps:
        step = (b - a) / PROBES
        probes += [(a + (k + 0.5) * step, step) for k in range(PROBES)]
    out = []
    stack: List[Tuple[float, str]] = []  # (end, name), nested ranges
    k = 0
    for t, us in probes:  # in time order
        while k < len(ranges) and ranges[k][0] <= t:
            s0, t0, name = ranges[k]
            while stack and stack[-1][0] < s0:
                stack.pop()
            stack.append((t0, name))
            k += 1
        open_ = [name for t0, name in stack if t0 >= t and name != WINDOW]
        spans = [n for n in open_ if n.startswith("pb.")]
        ops = [n for n in open_ if not n.startswith("pb.")]
        label = f"{spans[-1] if spans else '-'}>{ops[-1] if ops else '-'}"
        out.append((label, us))
    return out
