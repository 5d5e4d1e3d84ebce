"""The bytes and operations of the SLIM step's correlation backward (K5,
`corr_window_bwd_kernel`) and banded exact 1-NN (K6, `knn_banded_kernel`),
counted from the work each call's inputs define, and the readers of their
shares of the roofline.

Inside `recorded(record)` the program's entry points of the two kernels
(`ops/corr_fused.corr_window_bwd`, `ops/knn_banded._nn1_kernel`) are
wrapped: each call keeps what its count needs (shapes, the pixels' coords,
the clouds), and once the block has ended the counts add up in
`record.op_costs["K5"]` and `record.op_costs["K6"]` ([bytes, operations,
precision]). The readers take the kernels' device time by name from the
traced window, so the time and the count cover the same launches.

- K5: f0 and f1cat (bf16), the coords and the taps' cotangent (fp32) in,
  df0 and df1 (fp32) out, each read or written once; 4 C operations per tap
  inside a level (a product and a sum for each of df0 and df1), at the bf16
  peak (bf16 products summed in fp32).
- K6: the queries and refs (fp32 xyz) and their masks in, the distance and
  index out; 6 fp32 operations (3 multiply-adds) per pair that an exact
  search pruned by x alone must test once it knows the nearest distance:
  for each valid query, the valid refs whose x lies within the stop radius
  sqrt((d + 2^-17 |q|^2)(1 + 2^-16)) of the query's, d the exact squared
  nearest distance (the radius past which no ref can beat or tie d under
  the fp32 metric |q|^2 + |r|^2 - 2 q.r). The benchmark finds d itself, by
  an exact search.
"""
from __future__ import annotations

import math
from contextlib import ExitStack, contextmanager

import torch

from portbench.instrument import _patched
from portbench.reference.slim_step import nearest_index
from portbench.yardstick import least_seconds

KERNELS = {"K5": "corr_window_bwd_kernel", "K6": "knn_banded_kernel"}


def in_range_taps(coords_t: torch.Tensor, shapes, radius: int) -> int:
    """The taps of a (2r+2)^2 window around floor(coords / 2^l) that fall
    inside each level's (h, w) extent, summed over pixels and levels.
    coords_t [B, 2, HW] (row, col at level 0)."""
    total = 0
    for lvl, (hk, wk) in enumerate(shapes):
        c = torch.floor(coords_t.double() / 2.0**lvl).clamp(-1e6, 1e6)
        lo, hi = c - radius, c + radius + 1
        rows = (torch.minimum(hi[:, 0], torch.tensor(hk - 1.0, device=c.device))
                - torch.clamp(lo[:, 0], min=0.0) + 1).clamp(min=0)
        cols = (torch.minimum(hi[:, 1], torch.tensor(wk - 1.0, device=c.device))
                - torch.clamp(lo[:, 1], min=0.0) + 1).clamp(min=0)
        total += int((rows * cols).sum())
    return total


def corr_bwd_cost(f0, f1cat, coords_t, g, levels, radius):
    """K5's (bytes, operations) for one call (see the module docstring)."""
    c = f0.shape[-1]
    nbytes = (2 * (f0.numel() + f1cat.numel())
              + 4 * (coords_t.numel() + g.numel() + f0.numel() + f1cat.numel()))
    coords = coords_t.detach()
    shapes = tuple(levels.shapes)

    def count():
        return nbytes, 4.0 * c * in_range_taps(coords, shapes, radius)
    return count


def exact_nn_sqr(q, refs, q_valid, r_valid) -> torch.Tensor:
    """The exact squared distance of each valid query to its nearest valid
    ref (the reference's float64 search, `nearest_index`, and the pair's
    distance as a sum of squared differences). q [B, M, 3], refs [B, N, 3]
    -> [B, M] float64 (nan where the query is not valid)."""
    out = torch.full(q_valid.shape, float("nan"), dtype=torch.float64,
                     device=q.device)
    for i in range(q.shape[0]):
        r = refs[i][r_valid[i]].double()
        qi = q[i][q_valid[i]].double()
        if len(r) == 0 or len(qi) == 0:
            continue
        out[i][q_valid[i]] = ((qi - r[nearest_index(qi, r)]) ** 2).sum(-1)
    return out


def pruned_pairs(q, refs, q_valid, r_valid, d_exact) -> int:
    """The pairs an exact search pruned by x alone must test given the
    exact nearest distances (see the module docstring)."""
    total = 0
    for i in range(q.shape[0]):
        rx = torch.sort(refs[i][r_valid[i]][:, 0].double()).values
        qv = q[i][q_valid[i]].double()
        rad = torch.sqrt((d_exact[i][q_valid[i]] + 2.0**-17 * (qv ** 2).sum(-1))
                         * (1.0 + 2.0**-16))
        qx = qv[:, 0]
        total += int((torch.searchsorted(rx, qx + rad, right=True)
                      - torch.searchsorted(rx, qx - rad)).sum())
    return total


def knn_cost(q, refs, q_valid, r_valid):
    """K6's (bytes, operations) for one call (see the module docstring)."""
    # the call's own tensors, kept (no copy launched in the window)
    q3, r3 = q[..., :3].detach(), refs[..., :3].detach()
    qv, rv = q_valid, r_valid
    nbytes = 4 * (q3.numel() + r3.numel()) + qv.numel() + rv.numel() + 8 * qv.numel()

    def count():
        d = exact_nn_sqr(q3, r3, qv, rv)
        return nbytes, 6.0 * pruned_pairs(q3, r3, qv, rv, d)
    return count


@contextmanager
def recorded(record):
    """Within the block, every K5 and K6 call keeps its count; after it,
    the counts add up in `record.op_costs`."""
    from liso_tpu_torch.ops import corr_fused, knn_banded

    calls = []  # (label, count); autograd's thread appends K5's

    def bwd(fn):
        def wrapped(f0, f1cat, coords_t, g, levels, radius, plain=False):
            out = fn(f0, f1cat, coords_t, g, levels, radius, plain)
            if not plain and f0.device.type == "cuda":
                calls.append(("K5", corr_bwd_cost(f0, f1cat, coords_t, g,
                                                  levels, radius)))
            return out
        return wrapped

    def knn(fn):
        def wrapped(q, refs, q_valid, r_valid, *args, **kwargs):
            out = fn(q, refs, q_valid, r_valid, *args, **kwargs)
            calls.append(("K6", knn_cost(q, refs, q_valid, r_valid)))
            return out
        return wrapped

    with ExitStack() as stack:
        stack.enter_context(_patched(corr_fused, "corr_window_bwd", bwd))
        stack.enter_context(_patched(knn_banded, "_nn1_kernel", knn))
        yield
    precision = {"K5": "bf16", "K6": "fp32"}
    for label, count in calls:
        nbytes, nops = count()
        acc = record.op_costs.setdefault(label, [0.0, 0.0, precision[label]])
        acc[0] += nbytes
        acc[1] += nops


def roofline(record, label: str):
    """The kernel's share (%) of its roofline over the traced window: the
    least time of the work its calls were given over the device time of
    the kernels of its name. None where the window launched none of them
    or counted none."""
    tv = record.trace
    cost = record.op_costs.get(label)
    if tv is None or not cost:
        return None
    dev = sum(e.dur for e in tv.events if KERNELS[label] in e.name) * 1e-6
    if dev <= 0 or not math.isfinite(dev):
        return None
    return 100.0 * least_seconds(*cost) / dev
