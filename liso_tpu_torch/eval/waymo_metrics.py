"""Waymo-style detection metrics (a copy of liso_tpu/eval/waymo_metrics.py
onto the port's od_metrics).

Behavioral reference: liso/eval/od_metrics.py:1397-1919
(WaymoObjectDetectionMetrics + waymo_precisions_recalls_apscore). Key
deltas vs the nuScenes-style bank: a cropped evaluation FoV
(x in [-50, 50], y in [-20, 20] — the KITTI-like front crop), hungarian
IoU matching at threshold 0.4 (iou_bev and iou_3d), L1/L2 difficulty
categories (L1 ignores GT boxes with difficulty > 0, od_metrics.py:1533),
optional per-class split and absolute range bins, and the Waymo
recall-gap AP: consecutive PR points further than 0.05 recall apart get
conservative zero-precision points inserted before averaging.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from liso_tpu_torch.eval.od_metrics import (
    BoxArr,
    hungarian_match_by_iou,
)
from liso_tpu_torch.serve import resolve_device


def waymo_ap(precisions: np.ndarray, recalls: np.ndarray,
             max_recall_gap: float = 0.05) -> float:
    """od_metrics.py:1862-1919 — insert conservative points into recall
    gaps, then average precision over the augmented curve."""
    if len(precisions) == 0:
        return 0.0
    p = list(precisions)
    r = list(recalls)
    if r[-1] < 1.0 - 1e-6:
        # undetected remainder: terminal operating point p(1) = 0
        p.append(0.0)
        r.append(1.0)
    out_p = []
    prev_r = None
    for pi, ri in zip(p, r):
        if prev_r is not None:
            gap = ri - prev_r
            if gap > max_recall_gap + 1e-6:
                # insert the conservative (after-gap) precision
                # (od_metrics.py:1880 precision_value_after_gap)
                n_ins = int(gap / max_recall_gap) - 1
                out_p.extend([pi] * n_ins)
        out_p.append(pi)
        prev_r = ri
    return float(np.mean(out_p))


class WaymoObjectDetectionMetrics:
    CATEGORIES = ("L1", "L2")  # L1 ignores hard GT (difficulty > 0)

    def __init__(
        self,
        bev_range_min_xy_m: Tuple[float, float] = (-50.0, -20.0),
        bev_range_max_xy_m: Tuple[float, float] = (50.0, 20.0),
        criteria: Sequence[str] = ("iou_bev", "iou_3d"),
        iou_matching_threshold: float = 0.4,
        class_names: Sequence[str] = ("overall",),
        class_idxs: Sequence[int] = (0,),
        min_eval_range_m: Optional[float] = None,
        max_eval_range_m: Optional[float] = None,
        eval_movable_classes_as_one: bool = True,
        device=None,
    ):
        """`device`: where IoU matrices are computed when update() gets no
        cache (the card unless "cpu" is given)."""
        self.device = resolve_device(device)
        self.lo = np.asarray(bev_range_min_xy_m)
        self.hi = np.asarray(bev_range_max_xy_m)
        self.criteria = tuple(criteria)
        self.thresh = iou_matching_threshold
        self.class_names = tuple(class_names)
        self.class_idxs = tuple(class_idxs)
        self.min_eval_range_m = min_eval_range_m
        self.max_eval_range_m = max_eval_range_m
        self.eval_movable_classes_as_one = eval_movable_classes_as_one
        self.acc = {
            cn: {
                c: {cat: {"labels": [], "scores": [], "is_fn": []}
                    for cat in self.CATEGORIES}
                for c in self.criteria
            }
            for cn in self.class_names
        }

    def _crop(self, b: BoxArr, idx: np.ndarray):
        keep = np.all(
            (b["pos"][:, :2] >= self.lo) & (b["pos"][:, :2] <= self.hi),
            axis=-1,
        )
        if self.min_eval_range_m is not None and self.max_eval_range_m is not None:
            rng = np.linalg.norm(b["pos"][:, :2], axis=-1)
            keep &= (self.min_eval_range_m <= rng) & (rng < self.max_eval_range_m)
        return {k: v[keep] for k, v in b.items()}, idx[keep]

    def update(self, gt: BoxArr, pred: BoxArr, iou_cache=None):
        gi = np.arange(len(gt["pos"]))
        pi = np.arange(len(pred["pos"]))
        gt, gi = self._crop(gt, gi)
        pred, pi = self._crop(pred, pi)
        for ci, cn in zip(self.class_idxs, self.class_names):
            if cn == "overall":
                g, p, gic, pic = gt, pred, gi, pi
            else:
                kg = gt["class_id"][:, 0] == ci
                kp = pred["class_id"][:, 0] == ci
                g = {k: v[kg] for k, v in gt.items()}
                p = {k: v[kp] for k, v in pred.items()}
                gic, pic = gi[kg], pi[kp]
            for c in self.criteria:
                mat = None
                if iou_cache is not None and c in iou_cache:
                    mat = iou_cache[c][np.ix_(gic, pic)]
                self._update_one(g, p, c, cn, mat)

    def _update_one(self, gt: BoxArr, pred: BoxArr, c: str, cn: str, mat):
        idx_gt, idx_pred, matched_preds, matched_gts = hungarian_match_by_iou(
            gt, pred, self.thresh, c, mat=mat, device=self.device
        )
        scores = pred["probs"][:, 0]
        diff = gt.get("difficulty")
        if diff is None or not len(gt["pos"]):
            # no GT left (the crop, a range bin or the class split emptied
            # it): nothing to ignore. The JAX package reshapes the empty
            # difficulty array to (0, -1) here and raises.
            gt_is_hard = np.zeros(len(gt["pos"]), bool)
        else:
            gt_is_hard = np.reshape(diff, (len(gt["pos"]), -1))[:, 0] > 0
        for cat in self.CATEGORIES:
            ignore_gt = gt_is_hard if cat == "L1" else np.zeros_like(gt_is_hard)
            a = self.acc[cn][c][cat]
            ignore_matched = (
                ignore_gt[idx_gt] if len(idx_gt) else np.zeros(0, bool)
            )
            use_pred = np.ones_like(matched_preds)
            if len(idx_pred):
                use_pred[idx_pred] = ~ignore_matched
            fp = scores[use_pred & ~matched_preds]
            a["labels"].append(np.zeros(len(fp), bool))
            a["scores"].append(fp)
            a["is_fn"].append(np.zeros(len(fp), bool))
            n_fn = int((~matched_gts & ~ignore_gt).sum())
            a["labels"].append(np.ones(n_fn, bool))
            a["scores"].append(np.full(n_fn, -np.inf))
            a["is_fn"].append(np.ones(n_fn, bool))
            if len(idx_pred):
                tp = scores[idx_pred[~ignore_matched]]
                a["labels"].append(np.ones(len(tp), bool))
                a["scores"].append(tp)
                a["is_fn"].append(np.zeros(len(tp), bool))

    def compute(self) -> Dict[str, float]:
        out = {}
        for cn in self.class_names:
            for c in self.criteria:
                for cat in self.CATEGORIES:
                    a = self.acc[cn][c][cat]
                    key = (
                        f"waymo/AP_{cat}_{c}@{self.thresh}"
                        if cn == "overall"
                        else f"waymo/AP_{cn}_{cat}_{c}@{self.thresh}"
                    )
                    if not a["labels"] or not np.concatenate(
                        a["labels"]
                    ).any():
                        # empty bin: AP defined as 0 so the key taxonomy is
                        # stable across range bins (reference logs all banks)
                        out[key] = 0.0
                        continue
                    labels = np.concatenate(a["labels"])
                    scores = np.concatenate(a["scores"])
                    is_fn = np.concatenate(a["is_fn"])
                    order = np.argsort(-scores)
                    tp = fp = 0
                    n_gt = int(labels.sum())
                    precs, recs = [], []
                    for i in order:
                        if is_fn[i]:
                            continue
                        if labels[i]:
                            tp += 1
                        else:
                            fp += 1
                        precs.append(tp / (tp + fp))
                        recs.append(tp / max(n_gt, 1))
                    out[key] = waymo_ap(np.asarray(precs), np.asarray(recs))
        return out
