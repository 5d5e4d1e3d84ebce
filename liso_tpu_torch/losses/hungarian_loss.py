"""Hungarian set loss for query detectors (port of
liso_tpu/losses/hungarian_loss.py).

The optimal one-to-one assignment of GT boxes to predictions by BEV center
distance runs on the host: one copy of the [B, G, P] cost matrix to the
host, scipy's linear_sum_assignment per sample over the padded square
matrix (matches at or beyond DIST_MATCHING_THRESHOLD are dropped), and one
copy of the [B, G] match back. The JAX package makes the same host call
through one pure_callback. Everything else (the focal loss on matched
against unmatched predictions, the L1 terms of the matched attributes)
stays on the boxes' device. With a process group (`group`) the matching
stays per sample, one host stage per rank on its own shard, and the two
normalisers (the probs focal loss's positive count and the matched rows'
count) are the global batch's (parallel/mesh.py).

A prediction is a positive of the probs term iff a valid GT row is
assigned to it. The reference instead writes every GT row's flag to its
match and sends every unmatched row, padded rows included, to prediction 0
(liso_tpu/losses/hungarian_loss.py:67-70): in XLA:CPU's order a later
unmatched row clears a real match of prediction 0, and on a TPU or GPU the
order of such writes is not defined. The port scatters only the matched
rows.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from liso_tpu_torch.losses.centerpoint_loss import focal_heatmap_loss
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.parallel.mesh import batch_total

MAX_DIST = 1e5
DIST_MATCHING_THRESHOLD = 2.0


def assign_host(cost: np.ndarray) -> np.ndarray:
    """[B, G, P] padded cost -> [B, G] matched prediction index (-1
    unmatched)."""
    from scipy.optimize import linear_sum_assignment

    b, g, p = cost.shape
    out = -np.ones((b, g), np.int64)
    size = max(g, p)
    for i in range(b):
        padded = np.full((size, size), MAX_DIST, cost.dtype)
        padded[:g, :p] = cost[i]
        rows, cols = linear_sum_assignment(padded)
        for r, c in zip(rows, cols):
            if r < g and c < p and cost[i, r, c] < DIST_MATCHING_THRESHOLD:
                out[i, r] = c
    return out


def hungarian_match(gt: Boxes, pred: Boxes) -> torch.Tensor:
    """[B, G] index of the prediction each GT row is assigned to, -1 where
    none is (on the boxes' device)."""
    with torch.no_grad():
        dist = torch.linalg.norm(
            gt.pos[:, :, None, :2] - pred.pos[:, None, :, :2], dim=-1)
        dist = torch.where(gt.valid[:, :, None], dist, MAX_DIST)
        dist = torch.where(pred.valid[:, None, :], dist, MAX_DIST)
        match = assign_host(dist.cpu().numpy())
    return torch.from_numpy(match).to(gt.pos.device)


def hungarian_matching_loss(
    gt: Boxes, pred: Boxes, train_attrs=("pos", "dims", "rot", "probs"),
    group=None,
) -> Dict[str, torch.Tensor]:
    """gt [B, G], pred [B, P] fixed-capacity Boxes (pred.probs are logits).
    Returns the per-attribute losses, in the reference's key order; with a
    group, this rank's share of the global batch's."""
    b, p = pred.valid.shape
    match = hungarian_match(gt, pred)
    matched = (match >= 0) & gt.valid  # [B, G]
    safe = match.clamp(min=0)

    losses: Dict[str, torch.Tensor] = {}
    if "probs" in train_attrs:
        # positives: the predictions a valid GT row is assigned to, and
        # only those. The assignment is one-to-one; every other row writes
        # to a spare column p, which is dropped
        to = torch.where(matched, match, p)
        is_matched_pred = torch.zeros(
            b, p + 1, dtype=torch.bool, device=pred.valid.device
        ).scatter_(1, to, True)[:, :p]
        target = is_matched_pred.float()[..., None]
        losses["probs"] = focal_heatmap_loss(
            pred.probs, target, is_matched_pred, ignore_mask=~pred.valid,
            group=group)
    n_match = batch_total(matched.sum(), group).clamp(min=1)
    for attr in ("pos", "dims", "rot"):
        if attr not in train_attrs:
            continue
        src = getattr(pred, attr)
        pv = torch.gather(src, 1, safe[..., None].expand(-1, -1, src.shape[-1]))
        err = (pv - getattr(gt, attr)).abs().mean(-1)
        losses[attr] = torch.where(matched, err, 0.0).sum() / n_match
    return losses
