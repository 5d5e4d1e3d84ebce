"""What the per-layer readers that find kernels by name share.

A CUDA graph's replay launches its kernels through one `cudaGraphLaunch`,
inside no PyTorch operator and past the entry points that `instrument.py`
wraps, so a reader that goes by the operator (`aten::convolution`) or by
the benchmark's range around an op (`pb.op.K2`) does not see them. The
program's span open at the replay and each kernel's name are still in the
trace: these readers go by those, and read a stage launched one by one
and the same stage replayed alike.
"""
from __future__ import annotations


def events(record, span: str, keys) -> list:
    """The traced window's device events launched while the program's span
    `span` was open, whose kernel name holds one of `keys`; empty for an
    untraced run."""
    tv = record.trace
    if tv is None:
        return []
    return [e for e in tv.events
            if span in e.stack and any(k in e.name for k in keys)]
