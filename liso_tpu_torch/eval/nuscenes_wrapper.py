"""nuScenes-protocol detection metrics, devkit-exact (port of
liso_tpu/eval/nuscenes_wrapper.py: the quaternions through the port's
ops/transforms, the rest copied).

Behavioral reference: liso/eval/nuscenes_metrics_wrapper.py:22-441, which
converts Shape boxes to devkit DetectionBoxes (quaternions via pytorch3d)
and runs the official devkit DetectionMetrics with a custom movable-only
config (class_range 50 m, dist_ths {0.5,1,2,4}, dist_th_tp 2 m,
min_recall/min_precision 0.1, mean_ap_weight 5).

This wrapper reimplements the devkit pipeline NUMBER-EXACTLY (the JAX
package's copy is cross-checked against the vendored devkit run in-process
by tests/test_reference_metric_parity.py::test_nuscenes_devkit_cross_check,
and this one against the JAX package's by tests/test_torch_eval_metrics.py):

  * accumulate: global confidence-descending greedy matching per class and
    center-distance threshold, 101-point recall-grid interpolation of
    precision/confidence, nan-aware cumulative-mean TP-error curves
    re-interpolated on confidence
    (nuscenes-devkit/python-sdk/nuscenes/eval/detection/algo.py:16-151,
    common/utils.py:cummean);
  * calc_ap: precision clipped below min_recall/min_precision, normalized
    by (1 - min_precision) (algo.py:154-163);
  * calc_tp: mean error over the recall band [min_recall, max achieved
    recall] (algo.py:166-175);
  * DetectionMetrics aggregation: mean over thresholds then classes; TP
    scores max(0, 1 - err); NDS = (w*mAP + sum scores) / (w + 5)
    (detection/data_classes.py:198-287). Note the devkit counts a missing
    attribute error as the WORST score (attr errors are nan -> error curve
    of ones -> score 0), so a perfect no-attribute prediction lands at
    NDS = 0.9, matching the reference's reported numbers;
  * devkit-format submission JSON export (`to_devkit_json`) so the
    official tooling can verify the numbers independently.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from liso_tpu_torch.ops.transforms import matrix_to_quaternion  # devkit-compat

# nuscenes_metrics_wrapper.py:88-99 (traffic_cone / barrier excluded)
NUSC_CLASS_RANGES = {
    "car": 50.0,
    "truck": 50.0,
    "bus": 50.0,
    "trailer": 50.0,
    "construction_vehicle": 50.0,
    "pedestrian": 40.0,
    "motorcycle": 40.0,
    "bicycle": 40.0,
}
MEAN_AP_WEIGHT = 5.0  # custom_movable_only_eval_config["mean_ap_weight"]
DIST_THS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
NELEM = 101  # DetectionMetricData.nelem
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")


def _yaw_to_quat_wxyz(yaw: np.ndarray) -> np.ndarray:
    """Devkit rotation field: unit quaternion of the box pose (wxyz)."""
    rot = np.zeros((len(yaw), 3, 3), np.float64)
    c, s = np.cos(yaw), np.sin(yaw)
    rot[:, 0, 0], rot[:, 0, 1] = c, -s
    rot[:, 1, 0], rot[:, 1, 1] = s, c
    rot[:, 2, 2] = 1.0
    return matrix_to_quaternion(torch.from_numpy(rot)).numpy()


def _cummean(x: np.ndarray) -> np.ndarray:
    """devkit common/utils.cummean: nan-aware cumulative mean; all-nan ->
    ones."""
    if np.isnan(x).sum() == len(x):
        return np.ones(len(x))
    s = np.nancumsum(x.astype(float))
    n = np.cumsum(~np.isnan(x))
    return np.divide(s, n, out=np.zeros_like(s), where=n != 0)


def _angle_diff(x: float, y: float, period: float) -> float:
    diff = (x - y + period / 2) % period - period / 2
    if diff > np.pi:
        diff = diff - (2 * np.pi)
    return diff


_NO_PREDICTIONS = {
    "recall": np.linspace(0, 1, NELEM),
    "precision": np.zeros(NELEM),
    "confidence": np.zeros(NELEM),
    "trans_err": np.ones(NELEM),
    "vel_err": np.ones(NELEM),
    "scale_err": np.ones(NELEM),
    "orient_err": np.ones(NELEM),
    "attr_err": np.ones(NELEM),
}


def _calc_ap(md: Dict[str, np.ndarray]) -> float:
    """devkit algo.calc_ap with min_recall/min_precision 0.1."""
    prec = np.copy(md["precision"])[round(100 * MIN_RECALL) + 1 :]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def _calc_tp(md: Dict[str, np.ndarray], metric_name: str) -> float:
    """devkit algo.calc_tp: mean error over [min_recall, max recall]."""
    first = round(100 * MIN_RECALL) + 1
    nz = np.nonzero(md["confidence"])[0]
    last = int(nz[-1]) if len(nz) else 0  # max_recall_ind
    if last < first:
        return 1.0
    return float(np.mean(md[metric_name][first : last + 1]))


class NuscenesObjectDetectionMetrics:
    """update(gt, pred, sample_token=...) with valid-only box dicts;
    compute() -> devkit-exact protocol numbers; to_devkit_json(path) ->
    submission file for the official evaluator."""

    def __init__(
        self,
        moving_velocity_thresh: float = 0.1,  # kept for bank-API symmetry
        eval_movable_classes_as_one: bool = True,
        class_names: Optional[List[str]] = None,
    ):
        del moving_velocity_thresh
        self.eval_movable_classes_as_one = eval_movable_classes_as_one
        if eval_movable_classes_as_one:
            self.class_ranges = {"movable": 50.0}
        else:
            names = class_names or list(NUSC_CLASS_RANGES)
            self.class_ranges = {
                n: NUSC_CLASS_RANGES.get(n, 50.0) for n in names
            }
        self.class_names = list(self.class_ranges)
        # per sample token: list of per-box dicts (devkit EvalBoxes)
        self._gt: Dict[str, list] = {}
        self._pred: Dict[str, list] = {}
        self._results: Dict[str, list] = {}

    # ------------------------------------------------------------------
    def _range_filter(self, b: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Per-class max-distance filter
        (nuscenes_metrics_wrapper.filter_boxes_by_dist)."""
        if len(b["pos"]) == 0:
            return b
        dist = np.linalg.norm(b["pos"][:, :2], axis=-1)
        if self.eval_movable_classes_as_one or "class_id" not in b:
            max_d = self.class_ranges[next(iter(self.class_ranges))]
            keep = dist <= max_d
        else:
            ranges = np.asarray(list(self.class_ranges.values()))
            cid = np.clip(
                b["class_id"][:, 0].astype(np.int64), 0, len(ranges) - 1
            )
            keep = dist <= ranges[cid]
        return {k: v[keep] for k, v in b.items()}

    def _name(self, b: Dict[str, np.ndarray], i: int) -> str:
        if self.eval_movable_classes_as_one or "class_id" not in b:
            return "movable"
        ci = int(b["class_id"][i, 0])
        return (
            self.class_names[ci]
            if 0 <= ci < len(self.class_names)
            else self.class_names[0]
        )

    def _entries(self, b: Dict[str, np.ndarray], with_score: bool) -> list:
        k = len(b["pos"])
        velos = self._velo_xy(b, np.arange(k)) if k else np.zeros((0, 2))
        out = []
        for i in range(k):
            e = {
                "name": self._name(b, i),
                "xy": b["pos"][i, :2].astype(np.float64),
                "size": np.maximum(
                    b["dims"][i].astype(np.float64), 1e-4
                ),  # reference clips pred dims; devkit asserts > 0
                "yaw": float(b["rot"][i, 0]),
                "vel": velos[i].astype(np.float64),
                "attr": (
                    ""
                    if "attribute_name" not in b
                    else str(b["attribute_name"][i])
                ),
            }
            if with_score:
                e["score"] = float(b["probs"][i, 0])
            out.append(e)
        return out

    def update(
        self,
        gt: Dict[str, np.ndarray],
        pred: Dict[str, np.ndarray],
        sample_token: str = "",
        iou_cache=None,  # accepted for uniform bank API; dist matching
    ):
        del iou_cache
        token = sample_token or f"_sample{len(self._gt)}"
        gt = self._range_filter(gt)
        pred = self._range_filter(pred)
        self._gt[token] = self._entries(gt, with_score=False)
        self._pred[token] = self._entries(pred, with_score=True)
        if sample_token:
            self._record(pred, sample_token)

    @staticmethod
    def _velo_xy(b: Dict[str, np.ndarray], idx) -> np.ndarray:
        v = b.get("velo")
        if v is None:
            return np.zeros((len(idx), 2))
        v = np.asarray(v)[idx]
        if v.shape[-1] >= 2:
            return v[:, :2]
        # scalar speed along the box heading
        yaw = np.asarray(b["rot"])[idx, 0]
        return v[:, 0:1] * np.stack([np.cos(yaw), np.sin(yaw)], -1)

    # ------------------------------------------------------------------
    def _accumulate(self, class_name: str, dist_th: float):
        """devkit algo.accumulate, number-exact (empty class_mapping)."""
        npos = sum(
            1
            for boxes in self._gt.values()
            for g in boxes
            if g["name"] == class_name
        )
        if npos == 0:
            return dict(_NO_PREDICTIONS)
        preds = [
            (tok, p)
            for tok, boxes in self._pred.items()
            for p in boxes
            if p["name"] == class_name
        ]
        confs = [p["score"] for _, p in preds]
        # devkit tie-break: sorted by (conf, original index), reversed
        sortind = [
            i for (v, i) in sorted((v, i) for (i, v) in enumerate(confs))
        ][::-1]

        taken = set()
        tp, fp, conf = [], [], []
        md = {k: [] for k in TP_METRICS}
        md_conf = []
        for ind in sortind:
            tok, p = preds[ind]
            min_dist, match_idx = np.inf, None
            for gi, g in enumerate(self._gt[tok]):
                if g["name"] == class_name and (tok, gi) not in taken:
                    d = float(np.linalg.norm(p["xy"] - g["xy"]))
                    if d < min_dist:
                        min_dist, match_idx = d, gi
            if min_dist < dist_th:
                taken.add((tok, match_idx))
                g = self._gt[tok][match_idx]
                tp.append(1)
                fp.append(0)
                conf.append(p["score"])
                md["trans_err"].append(min_dist)
                md["vel_err"].append(float(np.linalg.norm(p["vel"] - g["vel"])))
                mn = np.minimum(g["size"], p["size"])
                inter = float(np.prod(mn))
                union = float(np.prod(g["size"]) + np.prod(p["size"]) - inter)
                md["scale_err"].append(1.0 - inter / union)
                md["orient_err"].append(
                    abs(_angle_diff(g["yaw"], p["yaw"], 2 * np.pi))
                )
                md["attr_err"].append(
                    np.nan
                    if g["attr"] == ""
                    else 1.0 - float(g["attr"] == p["attr"])
                )
                md_conf.append(p["score"])
            else:
                tp.append(0)
                fp.append(1)
                conf.append(p["score"])
        if not md_conf:
            return dict(_NO_PREDICTIONS)

        tp = np.cumsum(tp).astype(float)
        fp = np.cumsum(fp).astype(float)
        conf = np.array(conf)
        prec = tp / (fp + tp)
        rec = tp / float(npos)
        rec_interp = np.linspace(0, 1, NELEM)
        prec = np.interp(rec_interp, rec, prec, right=0)
        conf = np.interp(rec_interp, rec, conf, right=0)
        md_conf = np.array(md_conf)
        out = {"recall": rec_interp, "precision": prec, "confidence": conf}
        for key in TP_METRICS:
            tmp = _cummean(np.array(md[key]))
            out[key] = np.interp(conf[::-1], md_conf[::-1], tmp[::-1])[::-1]
        return out

    def compute(self) -> Dict[str, float]:
        label_aps: Dict[str, Dict[float, float]] = {}
        label_tp: Dict[str, Dict[str, float]] = {}
        details: Dict[str, float] = {}
        for cn in self.class_names:
            label_aps[cn] = {}
            for th in DIST_THS:
                md = self._accumulate(cn, th)
                label_aps[cn][th] = _calc_ap(md)
                details[f"AP_{cn}_overall_dist@{th}"] = label_aps[cn][th]
            md_tp = self._accumulate(cn, DIST_TH_TP)
            label_tp[cn] = {m: _calc_tp(md_tp, m) for m in TP_METRICS}

        mean_dist_aps = {
            cn: float(np.mean(list(d.values()))) for cn, d in label_aps.items()
        }
        mAP = float(np.mean(list(mean_dist_aps.values())))
        tp_errors = {
            m: float(np.nanmean([label_tp[cn][m] for cn in self.class_names]))
            for m in TP_METRICS
        }
        # devkit tp_scores: max(0, 1 - err); max(0., nan) -> 0. in python
        tp_scores = {m: max(0.0, 1.0 - tp_errors[m]) for m in TP_METRICS}
        nds = (MEAN_AP_WEIGHT * mAP + sum(tp_scores.values())) / (
            MEAN_AP_WEIGHT + len(tp_scores)
        )
        res = {
            "nusc/mAP": mAP,
            "nusc/mATE": tp_errors["trans_err"],
            "nusc/mASE": tp_errors["scale_err"],
            "nusc/mAOE": tp_errors["orient_err"],
            "nusc/mAVE": tp_errors["vel_err"],
            "nusc/mAAE": tp_errors["attr_err"],
            "nusc/NDS": nds,
            **{f"nusc/{k}": v for k, v in details.items()},
        }
        for cn, ap in mean_dist_aps.items():
            res[f"nusc/mAP_{cn}"] = ap
        return res

    # ------------------------------------------------------------------
    def render_summary_plots(self, out_dir) -> list:
        """Devkit-style summary plots (reference
        liso/eval/nuscenes_metrics_wrapper.py:71-441 render path /
        nuscenes devkit render.summary_plot): per class, the PR curves for
        every distance threshold plus the TP-error-vs-recall curves at the
        TP threshold, written as PNGs. Returns the written paths."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from pathlib import Path

        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        written = []
        for cn in self.class_names:
            fig, (ax_pr, ax_tp) = plt.subplots(1, 2, figsize=(9, 3.4),
                                               dpi=110)
            for th in DIST_THS:
                md = self._accumulate(cn, th)
                ap = _calc_ap(md)
                ax_pr.plot(
                    md["recall"], md["precision"],
                    label=f"dist@{th}m AP {ap:.3f}",
                )
            ax_pr.set_xlabel("recall")
            ax_pr.set_ylabel("precision")
            ax_pr.set_xlim(0, 1)
            ax_pr.set_ylim(0, 1.02)
            ax_pr.set_title(f"{cn}: PR")
            ax_pr.legend(fontsize=6)
            ax_pr.grid(alpha=0.3)
            md_tp = self._accumulate(cn, DIST_TH_TP)
            for m in TP_METRICS:
                if m in md_tp and np.asarray(md_tp[m]).size:
                    ax_tp.plot(md_tp["recall"], md_tp[m], label=m)
            ax_tp.set_xlabel("recall")
            ax_tp.set_ylabel("error")
            ax_tp.set_title(f"{cn}: TP errors @ {DIST_TH_TP}m")
            ax_tp.legend(fontsize=6)
            ax_tp.grid(alpha=0.3)
            fig.tight_layout()
            p = out_dir / f"nusc_summary_{cn}.png"
            fig.savefig(p)
            plt.close(fig)
            written.append(p)
        return written

    # ------------------------------------------------------------------
    def _record(self, pred: Dict[str, np.ndarray], token: str):
        """Accumulate devkit-submission entries
        (nuscenes_metrics_wrapper.translate_our_box_to_nusc_box)."""
        k = len(pred["pos"])
        quats = _yaw_to_quat_wxyz(pred["rot"][:, 0]) if k else np.zeros((0, 4))
        entries = []
        for i in range(k):
            vel = self._velo_xy(pred, np.asarray([i]))[0]
            entries.append(
                {
                    "sample_token": token,
                    "translation": [float(x) for x in pred["pos"][i]],
                    "size": [float(x) for x in pred["dims"][i]],
                    "rotation": [float(x) for x in quats[i]],
                    "velocity": [float(vel[0]), float(vel[1])],
                    "detection_name": self._name(pred, i),
                    "detection_score": float(pred["probs"][i, 0]),
                    "attribute_name": "",
                }
            )
        self._results[token] = entries

    def to_devkit_json(self, path) -> Path:
        """Official nuScenes submission format
        ({"meta": ..., "results": {token: [...]}}), verifiable with the
        devkit's DetectionEval."""
        path = Path(path)
        payload = {
            "meta": {
                "use_camera": False,
                "use_lidar": True,
                "use_radar": False,
                "use_map": False,
                "use_external": False,
            },
            "results": self._results,
        }
        path.write_text(json.dumps(payload))
        return path
