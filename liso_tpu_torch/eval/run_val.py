"""Validation loop: predictor (network | mined DB | flow clusters) vs GT
(port of liso_tpu/eval/run_val.py).

Behavioral reference: liso/eval/eval_ours.py:120-758 (run_val). Builds the
reference's FULL metric-bank matrix (eval_ours.py:160-260):

  * range-binned banks (0-1000 / 0-20 / 20-40 / 40-60 m) x
    {visible, benchmark, waymo_cropped} x {iou_3d, iou_bev}, all with the
    greedy nuScenes matcher, min_recall 0.0 and per-dataset min_precision
    (0.0 for AV2/waymo_cropped, else 0.1);
  * the official-protocol nuScenes bank (movable-as-one);
  * a per-class bank per dataset family (KITTI/AV2 -> ObjectDetectionMetrics,
    nuscenes -> per-class NuscenesObjectDetectionMetrics, waymo ->
    WaymoObjectDetectionMetrics);
  * Waymo-style banks per range bin (fed with benchmark GT);
  * scene-flow metrics (range bins 0/25/50/75/100 m) comparing the sample's
    flow source against GT flow (eval_ours.py:340-358).

Each rotated-IoU matrix is computed ONCE per (gt-variant, pred) pair on
the device (the card unless the caller passes device="cpu") and shared
across every bank via the iou_cache argument (the reference recomputes per
bank; results identical). Everything else is host numpy, as in the JAX
package.

Metric keys follow the reference's TB taxonomy:
  final_result/<category>/detection_metrics/<lo>_<hi>m/<bank keys>
  final_result/NUSC_OFFICIAL/detection_metrics/...
  final_result/<FAMILY>/per_class/detection_metrics/...
  final_result/WAYMO/detection_metrics/<lo>_<hi>m/...
  final_result/flow_metrics/...
plus unprefixed aliases of the 0-1000 m visible iou_bev bank (and ATE/ASE/
AOE) for cheap in-training TB filtering.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np

from liso_tpu_torch.eval.flow_metrics import FlowMetrics
from liso_tpu_torch.eval.nuscenes_wrapper import NuscenesObjectDetectionMetrics
from liso_tpu_torch.eval.od_metrics import (
    ObjectDetectionMetrics,
    iou_matrix_host,
)
from liso_tpu_torch.eval.waymo_metrics import WaymoObjectDetectionMetrics
from liso_tpu_torch.serve import resolve_device
from liso_tpu_torch.tracker.matching import greedy_match_by_confidence

RANGE_BINS = ((0.0, 1000.0), (0.0, 20.0), (20.0, 40.0), (40.0, 60.0))
WAYMO_CROP = (-50.0, -20.0, 50.0, 20.0)


def _to_valid_arrays(boxes: Dict[str, np.ndarray], b: int):
    """Batched padded box dict -> list of valid-only dicts."""
    out = []
    for i in range(b):
        v = np.asarray(boxes["valid"][i]).astype(bool)
        out.append(
            {
                k: np.asarray(x[i])[v]
                for k, x in boxes.items()
                if k != "valid"
            }
        )
    return out


KITTI_CAM_MIN_ANGLE_DEG = -41.95
KITTI_CAM_MAX_ANGLE_DEG = 40.16


def count_box_points_in_kitti_annotated_fov(
    boxes: Dict[str, np.ndarray], pcl: np.ndarray
) -> np.ndarray:
    """Points per box counting ONLY points inside the KITTI camera opening
    angle, with the box height ignored
    (eval_ours.count_box_points_in_kitti_annotated_fov:97-117). boxes:
    flat dict of [K, ...] arrays; pcl [N, >=3]."""
    ang = np.arctan2(pcl[:, 1], pcl[:, 0])
    in_fov = (ang >= np.deg2rad(KITTI_CAM_MIN_ANGLE_DEG)) & (
        ang <= np.deg2rad(KITTI_CAM_MAX_ANGLE_DEG)
    )
    p = pcl[in_fov, :3]
    counts = np.zeros(len(boxes["pos"]), np.int64)
    for i in range(len(boxes["pos"])):
        c, d = boxes["pos"][i], boxes["dims"][i]
        yaw = float(np.reshape(boxes["rot"][i], (-1,))[0])
        rel = p[:, :2] - c[:2]
        ca, sa = np.cos(-yaw), np.sin(-yaw)
        lx = rel[:, 0] * ca - rel[:, 1] * sa
        ly = rel[:, 0] * sa + rel[:, 1] * ca
        counts[i] = int(
            np.count_nonzero(
                (np.abs(lx) <= d[0] / 2) & (np.abs(ly) <= d[1] / 2)
            )
        )
    return counts


class MetricBanks:
    """The eval_ours.py:160-260 bank matrix as one object. Its IoU matrices
    are computed on `device` (the card unless "cpu" is given)."""

    def __init__(
        self,
        dataset_family: str = "kitti",
        moving_velocity_thresh: float = 0.1,
        movable_class_names: Optional[Sequence[str]] = None,
        class_idxs: Optional[Sequence[int]] = None,
        device=None,
    ):
        self.device = dev = resolve_device(device)
        self.family = dataset_family
        min_prec = 0.0 if dataset_family == "av2" else 0.1
        self.range_banks: Dict[str, ObjectDetectionMetrics] = {}
        for cat in ("visible", "benchmark"):
            for lo, hi in RANGE_BINS:
                for crit in ("iou_3d", "iou_bev"):
                    self.range_banks[
                        f"{cat}/detection_metrics/{int(lo)}_{int(hi)}m/{crit}"
                    ] = ObjectDetectionMetrics(
                        moving_velocity_thresh=moving_velocity_thresh,
                        use_slow_nuscenes_matching=True,
                        min_recall=0.0,
                        min_precision=min_prec,
                        box_matching_criterion=crit,
                        min_eval_range_m=lo,
                        max_eval_range_m=hi,
                        device=dev,
                    )
        for lo, hi in RANGE_BINS:
            for crit in ("iou_3d", "iou_bev"):
                self.range_banks[
                    "waymo_cropped/detection_metrics/"
                    f"{int(lo)}_{int(hi)}m/{crit}"
                ] = ObjectDetectionMetrics(
                    moving_velocity_thresh=moving_velocity_thresh,
                    use_slow_nuscenes_matching=True,
                    min_recall=0.0,
                    min_precision=0.0,
                    box_matching_criterion=crit,
                    iou_matching_thresholds=(0.3, 0.4, 0.5, 0.7),
                    filter_detections_by_bev_area_min_max_m=WAYMO_CROP,
                    min_eval_range_m=lo,
                    max_eval_range_m=hi,
                    device=dev,
                )
        self.nusc = NuscenesObjectDetectionMetrics(
            moving_velocity_thresh=moving_velocity_thresh,
            eval_movable_classes_as_one=True,
        )
        names = tuple(movable_class_names or ())
        idxs = tuple(class_idxs or range(len(names)))
        self.class_desc = {
            "kitti": "KITTI/per_class",
            "nuscenes": "NUSC_OFFICIAL/per_class",
            "av2": "AV2/per_class",
            "waymo": "WAYMO/per_class",
        }.get(dataset_family, f"{dataset_family.upper()}/per_class")
        if dataset_family == "nuscenes":
            self.class_bank = NuscenesObjectDetectionMetrics(
                moving_velocity_thresh=moving_velocity_thresh,
                eval_movable_classes_as_one=False,
                class_names=list(names) or None,
            )
        elif dataset_family == "waymo":
            self.class_bank = WaymoObjectDetectionMetrics(
                eval_movable_classes_as_one=False,
                class_names=names or ("overall",),
                class_idxs=idxs or (0,),
                device=dev,
            )
        else:
            self.class_bank = ObjectDetectionMetrics(
                moving_velocity_thresh=moving_velocity_thresh,
                use_slow_nuscenes_matching=True,
                min_recall=0.0,
                min_precision=0.0 if dataset_family == "av2" else 0.1,
                box_matching_criterion="iou_bev",
                class_names=names or ("overall",),
                class_idxs=idxs or (0,),
                eval_movable_classes_as_one=False,
                device=dev,
            )
        self.waymo_banks = {
            f"{int(lo)}_{int(hi)}m": WaymoObjectDetectionMetrics(
                min_eval_range_m=lo, max_eval_range_m=hi, device=dev
            )
            for lo, hi in RANGE_BINS
        }
        self.flow = FlowMetrics(range_bins=(0.0, 25.0, 50.0, 75.0, 100.0))

    # ------------------------------------------------------------------
    def update(
        self,
        gt: Dict[str, np.ndarray],
        benchmark_gt: Dict[str, np.ndarray],
        pred: Dict[str, np.ndarray],
        sample_token: str = "",
    ):
        cache_vis = {
            m: iou_matrix_host(gt, pred, m, self.device)
            for m in ("iou_bev", "iou_3d")
        }
        if benchmark_gt is gt:
            cache_bench = cache_vis
        else:
            cache_bench = {
                m: iou_matrix_host(benchmark_gt, pred, m, self.device)
                for m in ("iou_bev", "iou_3d")
            }
        for name, bank in self.range_banks.items():
            if name.startswith("benchmark/"):
                bank.update(benchmark_gt, pred, iou_cache=cache_bench)
            else:
                bank.update(gt, pred, iou_cache=cache_vis)
        for bank in self.waymo_banks.values():
            bank.update(benchmark_gt, pred, iou_cache=cache_bench)
        self.nusc.update(gt, pred, sample_token=sample_token)
        if isinstance(self.class_bank, NuscenesObjectDetectionMetrics):
            self.class_bank.update(gt, pred, sample_token=sample_token)
        else:
            self.class_bank.update(gt, pred, iou_cache=cache_vis)

    def compute(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        pre = "final_result/"
        for name, bank in self.range_banks.items():
            for k, v in bank.compute().items():
                out[f"{pre}{name}/{k}"] = v
        for k, v in self.nusc.compute().items():
            out[f"{pre}NUSC_OFFICIAL/detection_metrics/{k}"] = v
        for k, v in self.class_bank.compute().items():
            out[f"{pre}{self.class_desc}/detection_metrics/{k}"] = v
        for rng, bank in self.waymo_banks.items():
            for k, v in bank.compute().items():
                out[f"{pre}WAYMO/detection_metrics/{rng}/{k}"] = v
        for k, v in self.flow.compute().items():
            out[f"{pre}flow_metrics/{k}"] = v
        # unprefixed aliases of the headline bank for in-training TB filters
        alias_bank = self.range_banks["visible/detection_metrics/0_1000m/iou_bev"]
        out.update(alias_bank.compute())
        return out


def transfer_gt_class_ids(
    gt: Dict[str, np.ndarray],
    pred: Dict[str, np.ndarray],
    rng: np.random.RandomState,
    class_frequencies: Optional[np.ndarray] = None,
    n_classes: int = 1,
    matching_threshold: float = 3.0,
) -> Dict[str, np.ndarray]:
    """Class-agnostic detectors get class ids transferred from the nearest
    GT box (greedy, <= 3 m); unmatched predictions draw a random class id
    (frequency-weighted when known) — eval_ours.py:407-448."""
    k = len(pred["pos"])
    if class_frequencies is not None:
        cid = rng.choice(len(class_frequencies), size=k, p=class_frequencies)
    else:
        cid = rng.randint(0, max(n_classes, 1), size=k)
    cid = cid.astype(np.int64)
    if k and len(gt["pos"]) and "class_id" in gt:
        m = greedy_match_by_confidence(
            gt["pos"], pred["pos"], pred["probs"][:, 0],
            matching_threshold, match_in_nd=2,
        )
        if len(m.idxs_pred):
            cid[m.idxs_pred] = gt["class_id"][m.idxs_gt, 0].astype(np.int64)
    out = dict(pred)
    out["class_id"] = cid[:, None]
    return out


def run_val(
    batches: Iterable[dict],
    predict_boxes: Callable[[dict], Dict[str, np.ndarray]],
    *,
    moving_velocity_thresh: float = 0.1,
    dataset_family: str = "kitti",
    movable_class_names: Optional[Sequence[str]] = None,
    class_idxs: Optional[Sequence[int]] = None,
    class_frequencies: Optional[Sequence[float]] = None,
    max_batches: Optional[int] = None,
    kitti_annotated_fov_filter: bool = False,
    min_pts_in_annotated_fov: int = 10,
    predict_flow: Optional[Callable[[dict], np.ndarray]] = None,
    seed: int = 0,
    writer=None,
    log_images_num_batches: int = 0,
    bev_range_m=(100.0, 100.0),
    global_step: int = 0,
    summary_plot_dir=None,
    device=None,
) -> Dict[str, float]:
    """predict_boxes(batch) -> batched padded box dict (with 'valid').
    Batches must carry 'gt_boxes' (+ optionally 'gt_boxes_benchmark',
    'gt_flow_t0_t1'/'gt_moving_mask', 'pcl_full_w_ground'). With
    kitti_annotated_fov_filter, predictions outside the labeled camera FoV
    are dropped using the full-with-ground cloud, mirroring
    eval_ours.py:386-402 for KITTI tracking/object datasets. With a
    `writer`, the first `log_images_num_batches` batches are rendered as
    pred-vs-GT BEV panels (the reference's val image summaries,
    eval_ours.py:120-758 via visu/bbox_image.log_box_movement). The IoU
    matrices are computed on `device` (the card unless "cpu" is given); the
    predictor runs wherever it was built."""
    banks = MetricBanks(
        dataset_family=dataset_family,
        moving_velocity_thresh=moving_velocity_thresh,
        movable_class_names=movable_class_names,
        class_idxs=class_idxs,
        device=device,
    )
    rng = np.random.RandomState(seed)
    freqs = (
        np.asarray(class_frequencies, np.float64)
        if class_frequencies is not None
        else None
    )
    if freqs is not None:
        freqs = freqs / freqs.sum()
    n_classes = len(movable_class_names or ()) or 1
    n = 0
    for batch in batches:
        if max_batches is not None and n >= max_batches:
            break
        n += 1
        pred = predict_boxes(batch)
        b = len(batch["sample_id"])
        gts = _to_valid_arrays(batch["gt_boxes"], b)
        bench_key = (
            "gt_boxes_benchmark" if "gt_boxes_benchmark" in batch else "gt_boxes"
        )
        benches = (
            gts
            if bench_key == "gt_boxes"
            else _to_valid_arrays(batch[bench_key], b)
        )
        preds = _to_valid_arrays(pred, b)
        if kitti_annotated_fov_filter and "pcl_full_w_ground" in batch:
            for i, p in enumerate(preds):
                pcl_i = np.asarray(batch["pcl_full_w_ground"][i])
                if "pcl_full_valid" in batch:
                    pcl_i = pcl_i[np.asarray(batch["pcl_full_valid"][i], bool)]
                if len(p["pos"]):
                    n_pts = count_box_points_in_kitti_annotated_fov(p, pcl_i)
                    keep = n_pts >= min_pts_in_annotated_fov
                    preds[i] = {k: v[keep] for k, v in p.items()}
        # scene-flow metrics against GT flow (eval_ours.py:340-358)
        if "gt_flow_t0_t1" in batch:
            pred_flow = (
                predict_flow(batch)
                if predict_flow is not None
                else np.asarray(batch["flow_t0_t1"])
            )
            for i in range(b):
                banks.flow.update(
                    points=np.asarray(batch["pcl_t0"][i, :, :3]),
                    flow_pred=np.asarray(pred_flow[i]),
                    flow_gt=np.asarray(batch["gt_flow_t0_t1"][i]),
                    is_moving=np.asarray(batch["gt_moving_mask"][i], bool),
                    mask=np.asarray(batch["valid_t0"][i], bool),
                )
        if writer is not None and n <= log_images_num_batches:
            from liso_tpu_torch.visu.bbox_image import log_box_movement

            pcl = np.asarray(batch["pcl_t0"])
            if "valid_t0" in batch:
                # padding points sit at (0,0) — push them off-grid or every
                # panel gets a spurious ego-position blob
                vm = np.asarray(batch["valid_t0"], bool)
                pcl = np.where(vm[..., None], pcl, 1e9)
            log_box_movement(
                writer=writer,
                tag=f"val_images/batch{n - 1}",
                global_step=global_step,
                pcl_t0=pcl,
                pred_boxes=pred,
                gt_boxes=batch["gt_boxes"],
                bev_range_m=bev_range_m,
            )
        for i, (g, bench, p) in enumerate(zip(gts, benches, preds)):
            p = transfer_gt_class_ids(
                g, p, rng, class_frequencies=freqs, n_classes=n_classes
            )
            banks.update(
                g, bench, p, sample_token=str(batch["sample_id"][i])
            )
    if summary_plot_dir is not None:
        # devkit-style nuScenes summary plots (reference
        # nuscenes_metrics_wrapper.py:71-441 render path)
        try:
            banks.nusc.render_summary_plots(summary_plot_dir)
        except Exception as e:  # plotting must never fail an eval
            print(f"nusc summary plots failed: {e}")
    add_curve = getattr(writer, "add_pr_curve_bank", None)
    if writer is not None and add_curve is not None:
        # PR/ROC/TP-FP curve banks (reference od_metrics.py:547-1396): raw
        # PR-curve summaries for every range bank, rendered figure panels
        # for the headline 0-1000 m iou_bev bank (writers without the
        # method — test stubs, plain SummaryWriters — just skip curves)
        headline = "visible/detection_metrics/0_1000m/iou_bev"
        for name, bank in banks.range_banks.items():
            if not hasattr(bank, "curves"):
                continue
            for key, curve in bank.curves().items():
                add_curve(
                    f"curves/{name}/{key}", curve, global_step,
                    with_figure=(name == headline),
                )
    return banks.compute()


def mined_db_predictor(mined_db: Dict[str, dict]):
    """eval_ours.py:281-291: a mined-box DB dict acts as the predictor."""

    def predict(batch):
        b = len(batch["sample_id"])
        k_max = max(
            [len(mined_db.get(sid, {"track_id": []})["track_id"]) for sid in
             batch["sample_id"]] + [1]
        )
        out = {
            "pos": np.zeros((b, k_max, 3), np.float32),
            "dims": np.zeros((b, k_max, 3), np.float32),
            "rot": np.zeros((b, k_max, 1), np.float32),
            "probs": np.zeros((b, k_max, 1), np.float32),
            "velo": np.zeros((b, k_max, 1), np.float32),
            "valid": np.zeros((b, k_max), bool),
        }
        for i, sid in enumerate(batch["sample_id"]):
            entry = mined_db.get(sid)
            if entry is None:
                continue
            raw = entry["raw_box"]
            k = len(raw["pos"])
            for key in ("pos", "dims", "rot", "probs", "velo"):
                if key in raw:
                    out[key][i, :k] = raw[key]
            out["valid"][i, :k] = True
        return out

    return predict
