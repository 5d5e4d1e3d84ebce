"""Scene-flow metrics (EPE + inlier/outlier ratios, range-binned).

Behavioral reference: liso/eval/flow_metrics.py:13-166 and
liso/slim/utils/metrics.py:4-130. Host-side numpy accumulator with
moving/still/overall categories and range bins.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

CATEGORIES = ("still", "moving", "overall")


def inlier_outlier_ratios(pred_flow, gt_flow, mask) -> Dict[str, float]:
    """slim/utils/metrics.get_inlier_outlier_ratios semantics (verified
    value-exact against the reference in
    tests/test_reference_metric_parity.py): AccS/AccR are abs-OR-rel
    inlier ratios; Outliers is abs-OR-rel (NOT the KITTI abs-AND-rel
    convention — the reference calls that one RobustOutliers, with 0.3/0.3
    thresholds)."""
    epe = np.linalg.norm(pred_flow - gt_flow, axis=-1)
    gt_len = np.linalg.norm(gt_flow, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = epe / gt_len  # inf/nan exactly like the reference division
    n = max(int(np.count_nonzero(mask)), 1)
    return {
        "AccS": float(np.count_nonzero(((epe < 0.05) | (rel < 0.05)) & mask)) / n,
        "AccR": float(np.count_nonzero(((epe < 0.1) | (rel < 0.1)) & mask)) / n,
        "Outliers": float(np.count_nonzero(((epe > 0.3) | (rel > 0.1)) & mask))
        / n,
        "RobustOutliers": float(
            np.count_nonzero(((epe > 0.3) & (rel > 0.3)) & mask)
        ) / n,
    }


class FlowMetrics:
    def __init__(self, range_bins: Optional[Tuple[float, ...]] = None):
        if range_bins is None:
            range_bins = tuple(np.linspace(0.0, 100.0, 11))
        self.range_bins = np.asarray(range_bins)
        nb = len(range_bins) - 1
        self.num_pts_bin = {c: np.zeros(nb, np.int64) for c in CATEGORIES}
        self.aee_bin = {c: np.zeros(nb, np.float64) for c in CATEGORIES}
        self.total_aee = {c: 0.0 for c in CATEGORIES}
        self.total_pts = {c: 0 for c in CATEGORIES}
        self.acc_sums = {
            c: {"AccS": 0.0, "AccR": 0.0, "Outliers": 0.0,
                "RobustOutliers": 0.0, "n": 0}
            for c in CATEGORIES
        }

    def update(self, points, flow_pred, flow_gt, is_moving, mask):
        rng = np.linalg.norm(points[:, :3], axis=-1)
        epe = np.linalg.norm(flow_pred - flow_gt, axis=-1)
        cats = {
            "overall": mask,
            "still": mask & ~is_moving,
            "moving": mask & is_moving,
        }
        for c, m in cats.items():
            n = int(np.count_nonzero(m))
            if n == 0:
                continue
            # running mean over all points
            tot = self.total_pts[c] + n
            self.total_aee[c] = (
                self.total_aee[c] * self.total_pts[c] + float(epe[m].sum())
            ) / tot
            self.total_pts[c] = tot
            r = inlier_outlier_ratios(flow_pred, flow_gt, m)
            s = self.acc_sums[c]
            for k in ("AccS", "AccR", "Outliers", "RobustOutliers"):
                s[k] += r[k] * n
            s["n"] += n
            for b in range(len(self.range_bins) - 1):
                bm = m & (self.range_bins[b] <= rng) & (rng < self.range_bins[b + 1])
                nb = int(np.count_nonzero(bm))
                if nb == 0:
                    continue
                tot_b = self.num_pts_bin[c][b] + nb
                self.aee_bin[c][b] = (
                    self.aee_bin[c][b] * self.num_pts_bin[c][b]
                    + float(epe[bm].sum())
                ) / tot_b
                self.num_pts_bin[c][b] = tot_b

    def compute(self) -> Dict[str, float]:
        out = {}
        for c in CATEGORIES:
            out[f"AEE_{c}"] = float(self.total_aee[c])
            n = max(self.acc_sums[c]["n"], 1)
            for k in ("AccS", "AccR", "Outliers", "RobustOutliers"):
                out[f"{k}_{c}"] = self.acc_sums[c][k] / n
        return out
