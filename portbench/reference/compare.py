"""The numbers that decide `correct` for a training cell, taken from the
program's readings and the reference's (or the control's, which stands in
the program's place). It imports nothing of the program."""
from __future__ import annotations

import statistics

import numpy as np
import torch

# a leaf whose reference gradient is under this share of the median
# leaf's is moved by round-off alone under Adam (a bias before a norm)
QUIET_LEAF = 1e-3


def batch_gap(a, b) -> float:
    """Largest absolute difference over the arrays of two batches (pcl,
    valid, targets dict); inf where shapes or keys differ."""
    (pa, va, ta), (pb, vb, tb) = a, b
    if set(ta) != set(tb):
        return float("inf")
    gap = 0.0
    for x, y in [(pa, pb), (va, vb)] + [(ta[k], tb[k]) for k in ta]:
        if x.shape != y.shape:
            return float("inf")
        if x.size:
            gap = max(gap, float(np.max(np.abs(x.astype(np.float64)
                                               - y.astype(np.float64)))))
    return gap


def loss_rel(prog: list, ref: list) -> float:
    """Worst relative gap of a loss term over the steps."""
    gap = 0.0
    for lp, lr in zip(prog, ref):
        for k, r in lr.items():
            p = lp.get(k, float("nan"))
            gap = max(gap, abs(p - r) / max(abs(r), 1e-12))
    if len(prog) != len(ref) or not np.isfinite(gap):
        return float("inf")
    return gap


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def leaf_gaps(prog: dict, ref: dict, keys=None) -> dict:
    """Each leaf's |norm_prog - norm_ref| over max(norm_ref, the median
    leaf's norm_ref)."""
    keys = list(keys if keys is not None else ref)
    pn, rn = _norms({k: prog[k] for k in keys}), _norms({k: ref[k] for k in keys})
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}


def leaf_gap(prog: dict, ref: dict, keys=None) -> tuple:
    """The worst leaf's gap (`leaf_gaps`) and the leaf; inf where a norm is
    not finite."""
    gaps = leaf_gaps(prog, ref, keys)
    bad = [k for k, g in gaps.items() if not np.isfinite(g)]
    if bad:
        return float("inf"), bad[0]
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def moved_leaves(ref_grad: dict, state0: dict, ref_after: dict) -> list:
    """The state's leaves compared after the steps: the parameters whose
    reference gradient is not nought to rounding (over QUIET_LEAF of the
    median leaf's) and the statistics that the steps moved."""
    gn = _norms(ref_grad)
    med = statistics.median(gn.values())
    keys = [k for k, n in gn.items() if n > QUIET_LEAF * med]
    stats = [k for k in ref_after if k not in ref_grad
             and not torch.equal(ref_after[k], state0[k])]
    return keys + stats


def delta(after: dict, before: dict, keys) -> dict:
    return {k: after[k].double() - before[k].double() for k in keys}


def loss_rel_by_step(prog: list, ref: list) -> list:
    """Each step's worst relative loss gap and its term (diagnostics)."""
    out = []
    for lp, lr in zip(prog, ref):
        worst = max(lr, key=lambda k: abs(lp[k] - lr[k]) / max(abs(lr[k]), 1e-12))
        out.append([worst, abs(lp[worst] - lr[worst]) / max(abs(lr[worst]), 1e-12)])
    return out
