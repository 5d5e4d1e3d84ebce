"""Evaluation metrics: liso_tpu_torch against liso_tpu on the same inputs
(CPU).

Seeded numpy box sets go through both packages' metric banks:
ObjectDetectionMetrics in every matching mode (center distance with the
Hungarian or the nuScenes greedy matcher, rotated iou_bev and iou_3d with
the greedy matcher, with and without a precomputed IoU cache), the Waymo
bank (Hungarian IoU, L1 ignoring hard GT, crop, range bins, per class), the
nuScenes bank (movable-as-one and per class, and its devkit JSON) and the
whole MetricBanks matrix of run_val for every dataset family. The box sets
hold no boxes on either side, all-matched sets, rotated pairs, moving and
still objects, hard (ignored) GT and boxes outside the crop and range bins.
Every [G, P] matrix is 6 x 8 (or has an empty side), so JAX's eager IoU
traces once.

Limits: metric values within METRIC_ATOL (the same keys); IoU matrices
within IOU_ATOL of JAX's and within ORACLE_ATOL of the float64 oracle (the
JAX test's limit, tests/test_iou_nms.py); the rotation losses within
LOSS_ATOL; the class ids, the GT augmentation DB and the devkit JSON's
structure equal (its numbers within METRIC_ATOL). The run_val cases on a
SyntheticDataset and the detector's checkpoint are in
tests/test_torch_eval_cli.py.
"""
import json

import numpy as np
import pytest
import torch

from liso_tpu.data.dataset import DataCfg as JDataCfg
from liso_tpu.data.synthetic import SyntheticDataset as JSynthetic
from liso_tpu.eval import iou_oracle as j_oracle
from liso_tpu.eval import nuscenes_wrapper as jnusc
from liso_tpu.eval import od_metrics as jod
from liso_tpu.eval import run_val as jrv
from liso_tpu.eval import waymo_metrics as jwm
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu.utils import misc as jmisc
from liso_tpu_torch.data.dataset import DataCfg
from liso_tpu_torch.data.synthetic import SyntheticDataset
from liso_tpu_torch.eval import iou_oracle as t_oracle
from liso_tpu_torch.eval import nuscenes_wrapper as tnusc
from liso_tpu_torch.eval import od_metrics as tod
from liso_tpu_torch.eval import run_val as trv
from liso_tpu_torch.eval import waymo_metrics as twm
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.utils import misc as tmisc

torch.set_num_threads(1)
METRIC_ATOL = 1e-6
IOU_ATOL = 1e-5
ORACLE_ATOL = 2e-4
LOSS_ATOL = 1e-6
G, P = 6, 8


def _boxes(rng, k, spread=30.0):
    return {
        "pos": np.concatenate([rng.uniform(-spread, spread, (k, 2)),
                               rng.uniform(-1, 1, (k, 1))], -1).astype(np.float32),
        "dims": np.concatenate([rng.uniform(2.5, 5, (k, 1)), rng.uniform(1.5, 2.5, (k, 1)),
                                rng.uniform(1.2, 2, (k, 1))], -1).astype(np.float32),
        "rot": rng.uniform(-np.pi, np.pi, (k, 1)).astype(np.float32),
        "probs": rng.uniform(0.05, 1, (k, 1)).astype(np.float32),
        # half moving (speed 1-5 m/s), half still
        "velo": np.where(rng.rand(k, 1) < 0.5, rng.uniform(1, 5, (k, 1)),
                         rng.uniform(0, 0.05, (k, 1))).astype(np.float32),
        "class_id": rng.randint(0, 3, (k, 1)).astype(np.int64),
    }


def _near(rng, gt, pos_sigma, yaw_off, k_extra=P - G):
    """Predictions near the GT (shifted, turned) plus k_extra random ones."""
    p = {k: v.copy() for k, v in gt.items()}
    p["pos"] = (p["pos"] + rng.normal(0, pos_sigma, p["pos"].shape)).astype(np.float32)
    p["rot"] = (p["rot"] + yaw_off).astype(np.float32)
    p["dims"] = (p["dims"] * rng.uniform(0.85, 1.15, p["dims"].shape)).astype(np.float32)
    p["probs"] = rng.uniform(0.05, 1, (G, 1)).astype(np.float32)
    extra = _boxes(rng, k_extra)
    return {k: np.concatenate([p[k], extra[k]]) for k in p}


def _take(b, k):
    return {key: v[:k] for key, v in b.items()}


def box_sets(seed=0):
    """[(gt, benchmark_gt, pred, token)] covering the cases of the module
    docstring; every non-empty pair is G x P."""
    rng = np.random.RandomState(seed)
    out = []
    gt = _boxes(rng, G)
    # all matched (plus 2 false positives), exact copies among them
    exact = _near(rng, gt, 0.0, 0.0)
    exact["dims"][:G] = gt["dims"]
    out.append((gt, gt, exact, "all_matched"))
    gt = _boxes(rng, G)
    out.append((gt, gt, _near(rng, gt, 0.1, 0.0), "shifted"))
    gt = _boxes(rng, G)
    # rotated pairs: the same boxes turned by 10-60 degrees
    out.append((gt, gt, _near(rng, gt, 0.0, rng.uniform(0.17, 1.05, (G, 1))), "rotated"))
    gt = _boxes(rng, G, spread=60.0)  # range bins 20-40, 40-60 m, off the crop
    bench = _boxes(rng, G, spread=60.0)
    out.append((gt, bench, _near(rng, gt, 0.4, 0.3), "far_and_bench"))
    gt = _boxes(rng, G)
    out.append((gt, gt, _boxes(rng, P), "random"))
    out.append((_take(_boxes(rng, G), 0), _take(_boxes(rng, G), 0), _boxes(rng, P), "no_gt"))
    gt = _boxes(rng, G)
    out.append((gt, gt, _take(_boxes(rng, P), 0), "no_pred"))
    out.append((_take(gt, 0), _take(gt, 0), _take(gt, 0), "nothing"))
    return out


BOX_SETS = box_sets()


def _no_class(b):
    return {k: v for k, v in b.items() if k != "class_id"}


def assert_same_metrics(got, want, atol=METRIC_ATOL):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        g, w = float(got[k]), float(want[k])
        assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= atol, (k, g, w)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["iou_bev", "iou_3d"])
def test_iou_matrix_host_matches_jax_and_oracle(mode):
    for gt, bench, pred, _ in BOX_SETS:
        for g in (gt, bench):
            got = tod.iou_matrix_host(g, pred, mode, device="cpu")
            want = jod.iou_matrix_host(g, pred, mode)
            assert got.shape == want.shape == (len(g["pos"]), len(pred["pos"]))
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, want, atol=IOU_ATOL, rtol=0)
            if got.size:
                oracle = (t_oracle.iou_matrix_bev if mode == "iou_bev"
                          else t_oracle.iou_matrix_3d)
                args = (g["pos"], g["dims"], g["rot"], pred["pos"], pred["dims"],
                        pred["rot"])
                ref = oracle(*args)
                np.testing.assert_array_equal(
                    ref, getattr(j_oracle, oracle.__name__)(*args))
                np.testing.assert_allclose(got, ref, atol=ORACLE_ATOL, rtol=0)


METRIC_CASES = {
    "dist_hungarian": dict(box_matching_criterion="dist"),
    "dist_nuscenes_greedy": dict(box_matching_criterion="dist",
                                 use_slow_nuscenes_matching=True),
    "iou_bev": dict(box_matching_criterion="iou_bev",
                    use_slow_nuscenes_matching=True, min_recall=0.0),
    "iou_3d": dict(box_matching_criterion="iou_3d", min_precision=0.0,
                   min_recall=0.0),
    "iou_bev_crop_range": dict(
        box_matching_criterion="iou_bev", min_recall=0.0, min_precision=0.0,
        iou_matching_thresholds=(0.3, 0.4, 0.5, 0.7),
        filter_detections_by_bev_area_min_max_m=(-50.0, -20.0, 50.0, 20.0),
        min_eval_range_m=20.0, max_eval_range_m=40.0),
    "dist_per_class": dict(box_matching_criterion="dist",
                           class_names=("Car", "Pedestrian", "Cyclist"),
                           class_idxs=(0, 1, 2), moving_velocity_thresh=0.1),
}


# center-distance matching reads no IoU cache; the crop's subsets run with
# the cache only (each new [G, P] retraces JAX's eager IoU)
@pytest.mark.parametrize("case,cached", [
    ("dist_hungarian", False), ("dist_nuscenes_greedy", False),
    ("dist_per_class", False), ("iou_bev", False), ("iou_bev", True),
    ("iou_3d", False), ("iou_3d", True), ("iou_bev_crop_range", True)])
def test_object_detection_metrics_match_jax(case, cached):
    kw = METRIC_CASES[case]
    got = tod.ObjectDetectionMetrics(**kw, device="cpu")
    want = jod.ObjectDetectionMetrics(**kw)
    for gt, _, pred, _ in BOX_SETS:
        caches = (None, None)
        if cached:
            caches = tuple({m: f(gt, pred, m) for m in ("iou_bev", "iou_3d")}
                           for f in (lambda *a: tod.iou_matrix_host(*a, device="cpu"),
                                     jod.iou_matrix_host))
        got.update(gt, pred, iou_cache=caches[0])
        want.update(gt, pred, iou_cache=caches[1])
    out = got.compute()
    assert len(out) > 4
    assert_same_metrics(out, want.compute())
    gc, wc = got.curves(), want.curves()
    assert set(gc) == set(wc) and gc
    for k in wc:
        for f in ("recall", "precision", "confidence"):
            np.testing.assert_allclose(gc[k][f], wc[k][f], atol=METRIC_ATOL, rtol=0)
        assert gc[k]["n_gt"] == wc[k]["n_gt"]


def _with_difficulty(gt, bank, seed):
    """gt with Waymo difficulty labels 0-2, unless `bank`'s crop, range or
    class split leave no GT box (the JAX bank raises on an empty difficulty
    array)."""
    kept, _ = bank._crop(gt, np.arange(len(gt["pos"])))
    for ci, cn in zip(bank.class_idxs, bank.class_names):
        if not (kept["class_id"][:, 0] == ci).any() and cn != "overall" \
                or not len(kept["pos"]):
            return gt
    rng = np.random.RandomState(seed)
    return {**gt, "difficulty": rng.randint(0, 3, (len(gt["pos"]), 1))}


WAYMO_CASES = {
    "default": {},
    "range_20_40": dict(min_eval_range_m=20.0, max_eval_range_m=40.0),
    "per_class": dict(class_names=("VEHICLE", "PEDESTRIAN", "CYCLIST"),
                      class_idxs=(0, 1, 2), eval_movable_classes_as_one=False),
}


@pytest.mark.parametrize("case", sorted(WAYMO_CASES))
def test_waymo_metrics_match_jax(case):
    kw = WAYMO_CASES[case]
    got = twm.WaymoObjectDetectionMetrics(**kw, device="cpu")
    want = jwm.WaymoObjectDetectionMetrics(**kw)
    for i, (gt, bench, pred, _) in enumerate(BOX_SETS):
        bench = _with_difficulty(bench, want, i)
        cache = {m: jod.iou_matrix_host(bench, pred, m) for m in ("iou_bev", "iou_3d")}
        got.update(bench, pred, iou_cache=cache)
        want.update(bench, pred, iou_cache=cache)
    out = got.compute()
    assert out and any(v > 0 for v in out.values())
    assert_same_metrics(out, want.compute())
    assert twm.waymo_ap(np.array([1.0, 0.5]), np.array([0.2, 0.9])) == \
        jwm.waymo_ap(np.array([1.0, 0.5]), np.array([0.2, 0.9]))


def test_waymo_metrics_take_hard_gt_that_the_crop_removes():
    """A GT set with difficulty labels whose boxes all lie outside the crop
    counts as no GT at all (the JAX bank raises here)."""
    gt, _, pred, _ = BOX_SETS[0]
    far = {**gt, "pos": gt["pos"] + np.float32([0.0, 100.0, 0.0])}
    hard = {**far, "difficulty": np.ones((G, 1), np.int64)}
    outs = []
    for g in (hard, far):
        bank = twm.WaymoObjectDetectionMetrics(device="cpu")
        bank.update(g, pred)
        outs.append(bank.compute())
    assert outs[0] == outs[1] == {k: 0.0 for k in outs[0]} and outs[0]
    with pytest.raises(ValueError):
        jwm.WaymoObjectDetectionMetrics().update(hard, pred)


@pytest.mark.parametrize("as_one", [True, False], ids=["movable", "per_class"])
def test_nuscenes_metrics_and_devkit_json_match_jax(as_one, tmp_path):
    names = None if as_one else ["car", "pedestrian", "bicycle"]
    got = tnusc.NuscenesObjectDetectionMetrics(eval_movable_classes_as_one=as_one,
                                               class_names=names)
    want = jnusc.NuscenesObjectDetectionMetrics(eval_movable_classes_as_one=as_one,
                                                class_names=names)
    for gt, _, pred, token in BOX_SETS:
        got.update(gt, pred, sample_token=token)
        want.update(gt, pred, sample_token=token)
    assert_same_metrics(got.compute(), want.compute())
    g = json.loads(got.to_devkit_json(tmp_path / "port.json").read_text())
    w = json.loads(want.to_devkit_json(tmp_path / "jax.json").read_text())

    def same(a, b, path=""):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert list(a) == list(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}/{i}")
        elif isinstance(a, float):
            assert abs(a - b) <= METRIC_ATOL, (path, a, b)
        else:
            assert a == b, path

    same(g, w)
    # the 50 m class range drops some predictions
    assert 0 < sum(len(v) for v in g["results"].values()) < P * (len(BOX_SETS) - 2)


@pytest.mark.parametrize("family", ["kitti", "nuscenes", "waymo", "av2"])
def test_metric_banks_match_jax(family):
    names = {"kitti": ("Car", "Pedestrian", "Cyclist"), "nuscenes": None,
             "waymo": ("VEHICLE", "PEDESTRIAN", "CYCLIST"),
             "av2": ("REGULAR_VEHICLE", "PEDESTRIAN", "BICYCLIST")}[family]
    got = trv.MetricBanks(dataset_family=family, movable_class_names=names,
                          device="cpu")
    want = jrv.MetricBanks(dataset_family=family, movable_class_names=names)
    rng_t, rng_j = np.random.RandomState(3), np.random.RandomState(3)
    for gt, bench, pred, token in BOX_SETS:
        if family == "kitti":  # class ids of a class-agnostic detector
            pred_t = trv.transfer_gt_class_ids(gt, _no_class(pred), rng_t, n_classes=3)
            pred_j = jrv.transfer_gt_class_ids(gt, _no_class(pred), rng_j, n_classes=3)
            np.testing.assert_array_equal(pred_t["class_id"], pred_j["class_id"])
            pred = pred_t
        got.update(gt, bench, pred, sample_token=token)
        want.update(gt, bench, pred, sample_token=token)
    out = got.compute()
    assert len(out) > 400  # the full bank matrix
    assert out["AP_overall_overall_iou_bev@0.5"] > 0
    assert_same_metrics(out, want.compute())


def test_transfer_gt_class_ids_draws_as_jax():
    """The same RandomState draws, in the same order, give each unmatched
    prediction the same class id; matched ones take their GT's."""
    freqs = np.array([0.5, 0.3, 0.2])
    for kw in (dict(n_classes=3), dict(class_frequencies=freqs)):
        rt, rj = np.random.RandomState(7), np.random.RandomState(7)
        for gt, _, pred, _ in BOX_SETS:
            got = trv.transfer_gt_class_ids(gt, _no_class(pred), rt, **kw)
            want = jrv.transfer_gt_class_ids(gt, _no_class(pred), rj, **kw)
            np.testing.assert_array_equal(got["class_id"], want["class_id"])
        assert rt.randint(1 << 30) == rj.randint(1 << 30)


def test_kitti_fov_counts_and_valid_arrays_match_jax():
    rng = np.random.RandomState(1)
    pcl = np.concatenate([rng.uniform(-30, 30, (3000, 2)),
                          rng.uniform(-2, 2, (3000, 2))], -1).astype(np.float32)
    for gt, _, pred, _ in BOX_SETS:
        np.testing.assert_array_equal(
            trv.count_box_points_in_kitti_annotated_fov(pred, pcl),
            jrv.count_box_points_in_kitti_annotated_fov(pred, pcl))
    padded = {k: np.stack([v[:4], v[:4]]) for k, v in BOX_SETS[0][2].items()}
    padded["valid"] = np.array([[1, 0, 1, 1], [0, 0, 0, 0]], bool)
    for g, w in zip(trv._to_valid_arrays(padded, 2), jrv._to_valid_arrays(padded, 2)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------------------
def test_rotation_regularizers_match_jax():
    import jax.numpy as jnp

    rng = np.random.RandomState(2)
    raw = rng.normal(0, 1.2, (64, 2)).astype(np.float32)
    yaw = rng.uniform(-4, 4, (64, 1)).astype(np.float32)
    for f, x in (("rotation_vec_on_unit_circle_loss", raw),
                 ("limit_rotation_to_plusminus_half_pi_loss", yaw)):
        got = float(getattr(tmisc, f)(torch.from_numpy(x)))
        want = float(getattr(jmisc, f)(jnp.asarray(x)))
        assert abs(got - want) <= LOSS_ATOL, (f, got, want)
        assert got > 0.1
    with pytest.raises(ValueError):
        tmisc.rotation_vec_on_unit_circle_loss(torch.zeros(3, 3))


def _datasets(n_frames=4):
    cfg_t = DataCfg(bev=BevSetup((40.0, 40.0), (64, 64)), n_max=4096, m_max=12288,
                    use_skip_frames="never")
    cfg_j = JDataCfg(bev=JBev((40.0, 40.0), (64, 64)), n_max=4096, m_max=12288,
                     use_skip_frames="never")
    return SyntheticDataset(cfg_t, n_frames=n_frames), JSynthetic(cfg_j, n_frames=n_frames)


def test_gt_augmentation_db_and_flow_check_match_jax():
    tds, jds = _datasets()
    got = tmisc.build_augmentation_db_from_groundtruth(tds, max_samples=3)
    want = jmisc.build_augmentation_db_from_groundtruth(jds, max_samples=3)
    assert set(got) == set(want) and len(got["pcl_in_box_cosy"]) >= 3
    assert got["unique_track_id"] == want["unique_track_id"]
    for k in ("pcl_in_box_cosy", "lidar_rows", "box_T_sensor"):
        assert len(got[k]) == len(want[k])
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(got["boxes"], want["boxes"]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert_same_metrics(tmisc.sanity_check_flow(tds, max_num_samples=2),
                        jmisc.sanity_check_flow(jds, max_num_samples=2))


def test_cloud_loader_saver_and_timing(tmp_path):
    io = tmisc.CloudLoaderSaver()
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    io.save_sample(tmp_path / "a" / "x.npy", x)
    np.testing.assert_array_equal(io.load_sample(tmp_path / "a" / "x.npy"), x)
