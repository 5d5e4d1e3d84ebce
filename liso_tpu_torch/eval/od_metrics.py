"""Object-detection AP metrics, a host-side numpy accumulator (port of
liso_tpu/eval/od_metrics.py: `iou_matrix_host` on the port's ops/iou, the
rest copied).

Behavioral reference: liso/eval/od_metrics.py:25-545 (ObjectDetectionMetrics
without the plotting machinery) + liso/kabsch/box_groundtruth_matching.py
(match_bboxes hungarian / slow nuScenes greedy) +
box_groundtruth_matching_iou.py (greedy IoU matching). Semantics preserved:

  * matching criteria: center distance (hungarian by default, nuScenes
    greedy-by-confidence optional) or rotated iou_bev / iou_3d
    (greedy-by-confidence);
  * categories: overall / moving / still (velocity threshold), ignored-GT
    matches removed from both sides;
  * nuScenes-style AP: 101-point interpolated precision, min_recall /
    min_precision clipping;
  * TP error stats: ATE (center dist), ASE (1 - axis-aligned scale IoU),
    AOE (abs yaw diff).

The rotated IoU matrices run on the device (liso_tpu_torch.ops.iou: the
card unless the caller passes device="cpu"), one host copy per matrix;
accumulation is variable-length host numpy.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

import torch

from liso_tpu_torch.ops import iou as iou_ops
from liso_tpu_torch.serve import resolve_device
from liso_tpu_torch.tracker.matching import greedy_match_by_confidence

BoxArr = Dict[str, np.ndarray]


def calc_ap(precisions: np.ndarray, min_recall: float, min_precision: float):
    """od_metrics.py:25-39."""
    prec = np.copy(precisions)
    prec = prec[round(100 * min_recall) + 1 :]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def conf_prec_rec(labels, scores, is_fn):
    """od_metrics.py:42-81 (interpolated to 101 recall steps)."""
    order = np.argsort(-scores)
    tp, fp, conf = [], [], []
    for i in order:
        if is_fn[i]:
            continue
        tp.append(1 if labels[i] else 0)
        fp.append(0 if labels[i] else 1)
        conf.append(scores[i])
    tp = np.cumsum(tp).astype(float)
    fp = np.cumsum(fp).astype(float)
    conf = np.array(conf)
    n_gt = np.count_nonzero(labels)
    prec = tp / np.maximum(fp + tp, 1e-9)
    rec = tp / max(float(n_gt), 1e-9)
    rec_interp = np.linspace(0, 1, 101)
    if prec.size > 0:
        prec = np.interp(rec_interp, rec, prec, right=0)
        conf = np.interp(rec_interp, rec, conf, right=0)
    else:
        prec = np.full_like(rec_interp, np.nan)
        conf = np.full_like(rec_interp, np.nan)
    return conf, prec, rec_interp


def hungarian_match_by_dist(gt_pos, pred_pos, threshold, match_in_nd=2):
    """box_groundtruth_matching.match_bboxes: optimal assignment then
    threshold."""
    n_gt, n_pred = len(gt_pos), len(pred_pos)
    matched_preds = np.zeros(n_pred, bool)
    matched_gts = np.zeros(n_gt, bool)
    if n_gt == 0 or n_pred == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), matched_preds,
                matched_gts)
    dm = np.linalg.norm(
        gt_pos[:, None, :match_in_nd] - pred_pos[None, :, :match_in_nd], axis=-1
    )
    big = 1000.0
    size = max(n_gt, n_pred)
    padded = np.full((size, size), big)
    padded[:n_gt, :n_pred] = dm
    rows, cols = linear_sum_assignment(padded)
    keep = (rows < n_gt) & (cols < n_pred)
    rows, cols = rows[keep], cols[keep]
    ok = dm[rows, cols] < threshold
    idx_gt, idx_pred = rows[ok], cols[ok]
    matched_gts[idx_gt] = True
    matched_preds[idx_pred] = True
    return idx_gt, idx_pred, matched_preds, matched_gts


def iou_matrix_host(gt: BoxArr, pred: BoxArr, mode: str,
                    device=None) -> np.ndarray:
    """[G, P] rotated IoU computed on `device` (the card unless "cpu" is
    given), copied to the host once."""
    dev = resolve_device(device)
    n_gt, n_pred = len(gt["pos"]), len(pred["pos"])
    if n_gt == 0 or n_pred == 0:
        return np.zeros((n_gt, n_pred), np.float32)
    f = iou_ops.iou_matrix_bev if mode == "iou_bev" else iou_ops.iou_matrix_3d

    def on_dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    mat = f(
        on_dev(gt["pos"]), on_dev(gt["dims"]), on_dev(gt["rot"]),
        on_dev(pred["pos"]), on_dev(pred["dims"]), on_dev(pred["rot"]),
        torch.ones((n_gt,), dtype=torch.bool, device=dev),
        torch.ones((n_pred,), dtype=torch.bool, device=dev),
    )
    return mat.cpu().numpy()


def greedy_match_by_confidence_iou(
    gt: BoxArr, pred: BoxArr, threshold, mode, mat: Optional[np.ndarray] = None,
    device=None,
):
    """box_groundtruth_matching_iou.py:8-90. `mat` lets callers reuse one
    precomputed [G, P] IoU matrix across many (bank, threshold) pairs;
    without it the matrix is computed on `device`."""
    if mat is None:
        mat = iou_matrix_host(gt, pred, mode, device)
    n_gt, n_pred = mat.shape
    matched_preds = np.zeros(n_pred, bool)
    matched_gts = np.zeros(n_gt, bool)
    idx_gt, idx_pred = [], []
    order = np.argsort(-pred["probs"][:, 0]) if n_pred else []
    for p in order:
        col = np.where(matched_gts, -np.inf, mat[:, p])
        if n_gt == 0:
            break
        g = int(np.argmax(col))
        if col[g] > threshold:
            idx_gt.append(g)
            idx_pred.append(int(p))
            matched_gts[g] = True
            matched_preds[p] = True
    return (np.asarray(idx_gt, np.int64), np.asarray(idx_pred, np.int64),
            matched_preds, matched_gts)


def hungarian_match_by_iou(
    gt: BoxArr, pred: BoxArr, threshold, mode, mat: Optional[np.ndarray] = None,
    device=None,
):
    """Optimal-assignment IoU matching (reference
    box_groundtruth_matching_iou.match_boxes_by_descending_confidence_iou
    with matching_mode="hungarian", used by WaymoObjectDetectionMetrics)."""
    if mat is None:
        mat = iou_matrix_host(gt, pred, mode, device)
    n_gt, n_pred = mat.shape
    matched_preds = np.zeros(n_pred, bool)
    matched_gts = np.zeros(n_gt, bool)
    if n_gt == 0 or n_pred == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), matched_preds,
                matched_gts)
    rows, cols = linear_sum_assignment(-mat)
    ok = mat[rows, cols] > threshold
    idx_gt, idx_pred = rows[ok].astype(np.int64), cols[ok].astype(np.int64)
    matched_gts[idx_gt] = True
    matched_preds[idx_pred] = True
    return idx_gt, idx_pred, matched_preds, matched_gts


def scale_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    mn = np.minimum(a, b)
    inter = np.prod(mn, -1)
    union = np.prod(a, -1) + np.prod(b, -1) - inter
    return inter / np.maximum(union, 1e-6)


def abs_yaw_diff(a, b, period=2 * np.pi):
    d = (a - b + period / 2) % period - period / 2
    d = np.where(d > np.pi, d - 2 * np.pi, d)
    return np.abs(d)


class ObjectDetectionMetrics:
    CATEGORIES = ("overall", "moving", "still")

    def __init__(
        self,
        moving_velocity_thresh: float = 0.5,
        class_names: Sequence[str] = ("overall",),
        class_idxs: Sequence[int] = (0,),
        min_precision: float = 0.1,
        min_recall: float = 0.1,
        box_matching_criterion: str = "dist",
        use_slow_nuscenes_matching: bool = False,
        iou_matching_thresholds: Sequence[float] = (0.25, 0.3, 0.4, 0.5),
        min_eval_range_m: Optional[float] = None,
        max_eval_range_m: Optional[float] = None,
        filter_detections_by_bev_area_min_max_m: Optional[Sequence[float]] = None,
        eval_movable_classes_as_one: bool = True,
        device=None,
    ):
        """`device`: where IoU matrices are computed when update() gets no
        cache (the card unless "cpu" is given)."""
        self.device = resolve_device(device)
        # [xmin, ymin, xmax, ymax] crop applied to BOTH gt and preds
        # (reference od_metrics.py:199-267)
        self.bev_area_min_max = (
            None
            if filter_detections_by_bev_area_min_max_m is None
            else np.asarray(filter_detections_by_bev_area_min_max_m, np.float64)
        )
        self.eval_movable_classes_as_one = eval_movable_classes_as_one
        self.moving_velocity_thresh = moving_velocity_thresh
        self.class_names = tuple(class_names)
        self.class_idxs = tuple(class_idxs)
        self.criterion = box_matching_criterion
        self.use_slow_nuscenes_matching = use_slow_nuscenes_matching
        if box_matching_criterion == "dist":
            self.thresholds: Tuple[float, ...] = (0.5, 1.0, 2.0, 4.0)
            self.tp_metric_thresh = 2.0
        else:
            self.thresholds = tuple(iou_matching_thresholds)
            self.tp_metric_thresh = 0.5
        self.min_precision = min_precision
        self.min_recall = min_recall
        self.min_eval_range_m = min_eval_range_m
        self.max_eval_range_m = max_eval_range_m

        self.acc = {
            cn: {
                th: {cat: {"labels": [], "scores": [], "is_fn": []}
                     for cat in self.CATEGORIES}
                for th in self.thresholds
            }
            for cn in self.class_names
        }
        self.tp_stats = {
            cn: {th: {"ATE": 0.0, "ASE": 0.0, "AOE": 0.0, "tps": 0}
                 for th in self.thresholds}
            for cn in self.class_names
        }

    # ------------------------------------------------------------------
    def _filter(self, boxes: BoxArr, keep: np.ndarray) -> BoxArr:
        return {k: v[keep] for k, v in boxes.items()}

    @staticmethod
    def _keep_mask(boxes: BoxArr, lo_xy, hi_xy) -> np.ndarray:
        return np.all(
            (boxes["pos"][:, :2] >= lo_xy) & (boxes["pos"][:, :2] <= hi_xy),
            axis=-1,
        )

    def update(self, gt: BoxArr, pred: BoxArr, iou_cache=None):
        """gt/pred: dicts with pos [K,3], dims, rot, probs, velo (+optional
        class_id), already valid-only (variable K). iou_cache: optional
        {mode: [G, P] IoU matrix} computed on the UNFILTERED inputs — run_val
        computes each matrix once per sample and shares it across the whole
        bank matrix (the reference recomputes per bank; same results)."""
        gi = np.arange(len(gt["pos"]))
        pi = np.arange(len(pred["pos"]))
        if self.bev_area_min_max is not None:
            lo, hi = self.bev_area_min_max[:2], self.bev_area_min_max[2:]
            kg = self._keep_mask(gt, lo, hi)
            kp = self._keep_mask(pred, lo, hi)
            gt, gi = self._filter(gt, kg), gi[kg]
            pred, pi = self._filter(pred, kp), pi[kp]
        if self.min_eval_range_m is not None:
            for is_gt, b in ((True, gt), (False, pred)):
                rng = np.linalg.norm(b["pos"][:, :2], axis=-1)
                keep = (self.min_eval_range_m <= rng) & (
                    rng < self.max_eval_range_m
                )
                if is_gt:
                    gt, gi = self._filter(gt, keep), gi[keep]
                else:
                    pred, pi = self._filter(pred, keep), pi[keep]

        for ci, cn in zip(self.class_idxs, self.class_names):
            if cn == "overall":
                g, p, gic, pic = gt, pred, gi, pi
            else:
                kg = gt["class_id"][:, 0] == ci
                kp = pred["class_id"][:, 0] == ci
                g, gic = self._filter(gt, kg), gi[kg]
                p, pic = self._filter(pred, kp), pi[kp]
            sub = None
            if iou_cache is not None and self.criterion in iou_cache:
                sub = iou_cache[self.criterion][np.ix_(gic, pic)]
            for th in self.thresholds:
                self._update_one(g, p, th, cn, mat=sub)

    def _match(self, gt: BoxArr, pred: BoxArr, th: float, mat=None):
        if self.criterion == "dist":
            if self.use_slow_nuscenes_matching:
                m = greedy_match_by_confidence(
                    gt["pos"], pred["pos"], pred["probs"][:, 0], th, match_in_nd=2
                )
                return m.idxs_gt, m.idxs_pred, m.matched_preds_mask, m.matched_gts_mask
            return hungarian_match_by_dist(gt["pos"], pred["pos"], th)
        return greedy_match_by_confidence_iou(gt, pred, th, self.criterion,
                                              mat=mat, device=self.device)

    def _update_one(self, gt: BoxArr, pred: BoxArr, th: float, cn: str, mat=None):
        idx_gt, idx_pred, matched_preds, matched_gts = self._match(
            gt, pred, th, mat=mat
        )
        scores = pred["probs"][:, 0]
        velo = gt.get("velo")
        if velo is None:
            velo = np.zeros((len(gt["pos"]), 1), np.float32)
        gt_moving = np.linalg.norm(velo, axis=-1) > self.moving_velocity_thresh

        for cat in self.CATEGORIES:
            if cat == "overall":
                ignore_gt = np.zeros(len(gt["pos"]), bool)
            elif cat == "moving":
                ignore_gt = ~gt_moving
            else:
                ignore_gt = gt_moving
            self._accumulate(
                cn, th, cat, idx_gt, idx_pred, matched_preds, matched_gts,
                scores, ignore_gt,
            )

        n_tp = len(idx_gt)
        st = self.tp_stats[cn][th]
        st["tps"] += n_tp
        if n_tp:
            st["ATE"] += float(
                np.linalg.norm(
                    gt["pos"][idx_gt, :2] - pred["pos"][idx_pred, :2], axis=-1
                ).sum()
            )
            st["ASE"] += float(
                (1.0 - scale_iou(gt["dims"][idx_gt], pred["dims"][idx_pred])).sum()
            )
            st["AOE"] += float(
                abs_yaw_diff(
                    gt["rot"][idx_gt, 0], pred["rot"][idx_pred, 0]
                ).sum()
            )

    def _accumulate(self, cn, th, cat, idx_gt, idx_pred, matched_preds,
                    matched_gts, scores, ignore_gt):
        """od_metrics.update_specific_metrics: FPs (unmatched preds not
        matched to ignored GT), FNs (unignored undetected GT, score -inf),
        TPs (matches to unignored GT)."""
        a = self.acc[cn][th][cat]
        ignore_matched = ignore_gt[idx_gt] if len(idx_gt) else np.zeros(0, bool)
        use_pred = np.ones_like(matched_preds)
        if len(idx_pred):
            use_pred[idx_pred] = ~ignore_matched
        # FPs
        fp_scores = scores[use_pred & ~matched_preds]
        a["labels"].append(np.zeros(len(fp_scores), bool))
        a["scores"].append(fp_scores)
        a["is_fn"].append(np.zeros(len(fp_scores), bool))
        # FNs
        n_fn = int((~matched_gts & ~ignore_gt).sum())
        a["labels"].append(np.ones(n_fn, bool))
        a["scores"].append(np.full(n_fn, -np.inf))
        a["is_fn"].append(np.ones(n_fn, bool))
        # TPs
        if len(idx_pred):
            tp_scores = scores[idx_pred[~ignore_matched]]
            a["labels"].append(np.ones(len(tp_scores), bool))
            a["scores"].append(tp_scores)
            a["is_fn"].append(np.zeros(len(tp_scores), bool))

    # ------------------------------------------------------------------
    def curves(self):
        """Per (class, threshold, category): interpolated PR + ROC-style
        arrays for TB curve logging (reference od_metrics.py:547-1396 logs
        these via SummaryWriter.add_pr_curve-equivalent raw summaries).
        Returns {key: {"recall", "precision", "confidence"}}."""
        out = {}
        for cn in self.class_names:
            for th in self.thresholds:
                for cat in self.CATEGORIES:
                    a = self.acc[cn][th][cat]
                    if not a["labels"]:
                        continue
                    labels = np.concatenate(a["labels"])
                    scores = np.concatenate(a["scores"])
                    is_fn = np.concatenate(a["is_fn"])
                    if not labels.any():
                        continue
                    conf, prec, rec = conf_prec_rec(labels, scores, is_fn)
                    out[f"{cn}_{cat}_{self.criterion}@{th}"] = {
                        "recall": rec,
                        "precision": prec,
                        "confidence": conf,
                        "n_gt": int(np.count_nonzero(labels)),
                    }
        return out

    def compute(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for cn in self.class_names:
            aps = []
            for th in self.thresholds:
                for cat in self.CATEGORIES:
                    a = self.acc[cn][th][cat]
                    if not a["labels"]:
                        continue
                    labels = np.concatenate(a["labels"])
                    scores = np.concatenate(a["scores"])
                    is_fn = np.concatenate(a["is_fn"])
                    if not labels.any():
                        continue
                    _, prec, _ = conf_prec_rec(labels, scores, is_fn)
                    if np.isnan(prec).all():
                        ap = 0.0
                    else:
                        ap = calc_ap(prec, self.min_recall, self.min_precision)
                    out[f"AP_{cn}_{cat}_{self.criterion}@{th}"] = ap
                    if cat == "overall":
                        aps.append(ap)
            if aps:
                out[f"mAP_{cn}_{self.criterion}"] = float(np.mean(aps))
            st = self.tp_stats[cn][self.tp_metric_thresh]
            n = max(st["tps"], 1)
            out[f"ATE_{cn}"] = st["ATE"] / n
            out[f"ASE_{cn}"] = st["ASE"] / n
            out[f"AOE_{cn}"] = st["AOE"] / n
        return out
