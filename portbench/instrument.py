"""Ranges around the hand-written kernels' ops, for a traced sub-window.

Inside `wrap_ops`, each op's entry point in the program runs inside a
`pb.op.<label>` profiler range, and the op's bytes and operations, counted
from its own inputs and outputs by `yardstick` once the block has ended,
add up in `record.op_costs[label]`. The readers then take the op's device time from
the trace by that range, whatever kernel a later version launches there.
"""
from __future__ import annotations

from contextlib import ExitStack, contextmanager

from portbench import yardstick

# label -> (module, attribute, cost function, precision of its arithmetic:
# None takes the first argument's dtype)
OPS = {
    "K1": ("liso_tpu_torch.ops.grid_scatter", "_grid_scatter_max_occ_fwd",
           lambda a, out: yardstick.scatter_max_cost(*a[:3], out), None),
    "K1_vjp": ("liso_tpu_torch.ops.grid_scatter", "scatter_max_vjp",
               lambda a, out: yardstick.scatter_max_vjp_cost(*a[:4], out),
               None),
    "K2": ("liso_tpu_torch.ops.corr_fused", "_fused_corr_window_fwd",
           lambda a, out: yardstick.corr_window_cost(*a[:5], out), "bf16"),
}


@contextmanager
def _patched(module, attr, wrapper):
    original = getattr(module, attr)
    setattr(module, attr, wrapper(original))
    try:
        yield
    finally:
        setattr(module, attr, original)


@contextmanager
def wrap_ops(record, labels):
    import importlib

    from torch.profiler import record_function

    def make(label, cost, precision):
        def wrapper(fn):
            def wrapped(*args, **kwargs):
                with record_function(f"pb.op.{label}"):
                    out = fn(*args, **kwargs)
                prec = precision or yardstick.precision_of(args[0].dtype)
                calls.append((label, prec, cost(args, out)))
                return out
            return wrapped
        return wrapper

    calls = []
    with ExitStack() as stack:
        for label in labels:
            mod, attr, cost, precision = OPS[label]
            stack.enter_context(_patched(importlib.import_module(mod), attr,
                                         make(label, cost, precision)))
        yield
    for label, prec, count in calls:
        nbytes, nops = count()
        acc = record.op_costs.setdefault(label, [0.0, 0.0, prec])
        acc[0] += nbytes
        acc[1] += nops
