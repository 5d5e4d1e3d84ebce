"""Shared arithmetic of the per-layer readers (`portbench/metrics/*.py`).

Each reader takes the run's `harness.RunRecord` and returns a number or
None when its run holds nothing to read (an untraced run, a stage the cell
does not have); the harness then leaves the metric out of the line.
"""
from __future__ import annotations

from portbench.yardstick import PEAK_FLOPS, least_seconds

CONV_OPS = ("aten::convolution", "aten::convolution_backward")


def conv_ms(record):
    """Device milliseconds per traced step in kernels that a convolution
    launched, forward or backward (by the operator that launched them)."""
    tv = record.trace
    if tv is None:
        return None
    s = tv.device_s(lambda stack: any(op in stack for op in CONV_OPS))
    return s / tv.steps * 1e3


def device_idle(record):
    """Share, in %, of the device-only traced pass with no operation on
    the device."""
    d = record.device
    if d is None or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])


def kernel_roofline(record, labels):
    """Sum of the ops' least times over the sum of their device times, in
    %, over the hand-written kernels' ops named by `labels` (the
    benchmark's ranges around each op's entry, `pb.op.<label>`). None when
    the traced window launched none of them."""
    tv = record.trace
    if tv is None:
        return None
    least, dev = 0.0, 0.0
    for label in labels:
        cost = record.op_costs.get(label)
        if not cost:
            continue
        nbytes, nops, precision = cost
        span = f"pb.op.{label}"
        t = tv.device_s(lambda stack, span=span: span in stack)
        if t <= 0:
            continue
        least += least_seconds(nbytes, nops, precision)
        dev += t
    if dev <= 0:
        return None
    return 100.0 * least / dev


def mfu(record):
    """The model's operations per step over the window's time per step,
    as a share (%) of the peak of the configuration's precision. The
    window is the untraced one, so the profiler's cost is not in it; the
    operations are counted after it (`flops_per_step`, on the meta
    device), so their count costs neither the set-up nor the window."""
    w = record.workload
    if not record.step_s or record.trace is None:
        return None
    rate = w.flops_per_step * len(record.step_s) / record.window_s
    return 100.0 * rate / PEAK_FLOPS[w.precision]
