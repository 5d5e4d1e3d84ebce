"""Faults planted in the SLIM train step, to show that `slim_train_b1`'s
check catches them: K6's answer swapped for the second-nearest point on 1%
of the queries (`knn_second`), the correlation's backward (K5) scaled by
1.01 (`corr_bwd_scaled`), RMSprop's decay at torch's 0.99 in place of
optax's 0.9 (`rmsprop_decay`), and the dynamicness threshold left unmoved
(`thr_unmoved`). Used by `portbench/tests/test_pb_slim.py` (CPU, small
sizes); each applies on the card too."""
from __future__ import annotations

import torch

from portbench.faults import _patch

KINDS = ("knn_second", "corr_bwd_scaled", "rmsprop_decay", "thr_unmoved")


def _second_nearest(q, refs, q_valid, r_valid, d, idx, every: int = 100):
    """(d, idx) with every `every`-th valid query of each cloud given its
    second-nearest valid ref."""
    d, idx = d.clone(), idx.clone()
    for b in range(q.shape[0]):
        rows = torch.nonzero(q_valid[b])[:, 0][::every]
        cand = torch.nonzero(r_valid[b])[:, 0]
        if len(rows) == 0 or len(cand) < 2:
            continue
        dist = torch.cdist(q[b, rows, :3].float(), refs[b, cand, :3].float())
        second = cand[dist.topk(2, largest=False).indices[:, 1]]
        d[b, rows] = ((q[b, rows, :3] - refs[b, second, :3]) ** 2).sum(-1)
        idx[b, rows] = second.to(idx.dtype)
    return d, idx


def plant(kind: str):
    from liso_tpu_torch.ops import corr_fused, knn_banded
    from liso_tpu_torch.train import slim_train

    if kind == "knn_second":
        real = knn_banded.nn_1_sorted

        def swapped(q, refs, q_valid, r_valid, *args, **kwargs):
            d, idx = real(q, refs, q_valid, r_valid, *args, **kwargs)
            return _second_nearest(q, refs, q_valid, r_valid, d, idx)
        return _patch(knn_banded, "nn_1_sorted", swapped)
    if kind == "corr_bwd_scaled":
        real_bwd = corr_fused.corr_window_bwd

        def scaled(*args, **kwargs):
            return tuple(1.01 * x for x in real_bwd(*args, **kwargs))
        return _patch(corr_fused, "corr_window_bwd", scaled)
    if kind == "rmsprop_decay":
        return _patch(slim_train, "RMSPROP_DECAY", 0.99)
    if kind == "thr_unmoved":
        return _patch(slim_train, "movavg_update_batched",
                      lambda state, *args, **kwargs: state)
    raise ValueError(kind)
