"""Exact nearest-neighbour search (port of liso_tpu/ops/knn.py).

||q - r||^2 = |q|^2 + |r|^2 - 2 q.r over query chunks, so peak memory is
[chunk, Nr] whatever Nq is. Padded points carry a 1e9 penalty through the
validity masks, so argmin never selects them. This is the plain version of
the banded kernel K6 (ops/knn_banded.py) and the CPU path of the SLIM loss.
The dot must be IEEE fp32: a reduced-precision dot (TF32) finds the true
neighbour for only about a quarter of the queries at |coords| ~ 60 m, so
callers on the card keep `torch.backends.cuda.matmul.allow_tf32` False.
"""
from __future__ import annotations

import torch

BIG = 1e9


def nn_1(queries: torch.Tensor, refs: torch.Tensor, q_valid: torch.Tensor,
         r_valid: torch.Tensor, chunk: int = 2048):
    """1-NN of each query in refs. queries [Nq, D], refs [Nr, D] (D = 2 or
    3), bool validity masks. Returns (sq_dist [Nq] fp32, idx [Nq] int32):
    invalid queries get (BIG, 0); invalid refs are never selected; ties
    take the lowest index."""
    r2 = (refs * refs).sum(-1)
    r_pen = torch.where(r_valid, 0.0, BIG).to(refs.dtype)
    dists, idxs = [], []
    for s in range(0, queries.shape[0], chunk):
        q = queries[s : s + chunk]
        v = q_valid[s : s + chunk]
        q2 = (q * q).sum(-1)
        dots = torch.matmul(q, refs.T)
        sq = q2[:, None] + r2[None, :] - 2.0 * dots + r_pen[None, :]
        idx = torch.argmin(sq, dim=-1)
        best = torch.gather(sq, 1, idx[:, None])[:, 0]
        dists.append(torch.where(v, best.clamp(min=0.0), BIG))
        idxs.append(torch.where(v, idx, 0))
    return torch.cat(dists), torch.cat(idxs).to(torch.int32)


def knn_gather(refs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather ref points by NN index."""
    return refs[idx.long()]
