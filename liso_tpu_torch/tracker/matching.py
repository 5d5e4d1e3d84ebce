"""Greedy box matching (host-side numpy).

Behavioral reference: liso/kabsch/box_groundtruth_matching.py:154-229
(slow_greedy_match_boxes_by_desending_confidence_by_dist) — descending
prediction confidence, each pred grabs its nearest unclaimed GT within the
threshold. The reference's O(P*G) Python loop is replaced by the same greedy
order over a precomputed distance matrix with claimed-GT masking.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class MatchResult(NamedTuple):
    idxs_gt: np.ndarray  # [M] matched gt indices (match order)
    idxs_pred: np.ndarray  # [M] matched pred indices
    dists: np.ndarray  # [M]
    matched_preds_mask: np.ndarray  # [P] bool
    matched_gts_mask: np.ndarray  # [G] bool


def greedy_match_by_confidence(
    gt_pos: np.ndarray,
    pred_pos: np.ndarray,
    pred_conf: np.ndarray,
    matching_threshold: float,
    match_in_nd: int = 3,
) -> MatchResult:
    gt_pos = np.asarray(gt_pos, np.float32)[..., :match_in_nd]
    pred_pos = np.asarray(pred_pos, np.float32)[..., :match_in_nd]
    n_gt, n_pred = len(gt_pos), len(pred_pos)
    matched_preds = np.zeros(n_pred, bool)
    matched_gts = np.zeros(n_gt, bool)
    idxs_gt, idxs_pred, dists = [], [], []
    if n_gt and n_pred:
        dm = np.linalg.norm(
            gt_pos[:, None, :] - pred_pos[None, :, :], axis=-1
        )  # [G, P]
        order = np.argsort(-np.asarray(pred_conf))
        for p in order:
            col = np.where(matched_gts, np.inf, dm[:, p])
            g = int(np.argmin(col))
            if col[g] < matching_threshold:
                idxs_gt.append(g)
                idxs_pred.append(int(p))
                dists.append(float(col[g]))
                matched_gts[g] = True
                matched_preds[p] = True
    return MatchResult(
        np.asarray(idxs_gt, np.int64),
        np.asarray(idxs_pred, np.int64),
        np.asarray(dists, np.float32),
        matched_preds,
        matched_gts,
    )
