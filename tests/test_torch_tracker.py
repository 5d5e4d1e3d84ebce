"""The tracker's device parts: liso_tpu_torch against liso_tpu on the same
seeded numpy inputs (CPU, fp32).

- tracker/propagation.py: mean flow per box, propagation, yaw alignment;
- tracker/box_fitting.py: fit_2d_box, every method;
- tracker/refinement.py: refine_track_boxes;
- tracker/smoothing.py: smooth_track_jerk and the bike model after 20
  Adam iterations (rounding) and 200 (the reference's own spread);
- tracker/mining.py: the per-frame device program and union_proposals;
- tracker/dbs.py: a DB written by either package loads in the other;
- data/icp.py's native library, built from the port's own copy of
  icp.cpp, against the numpy path.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from liso_tpu.ops import boxes as jboxes
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu.tracker import box_fitting as jfit
from liso_tpu.tracker import dbs as jdbs
from liso_tpu.tracker import mining as jmin
from liso_tpu.tracker import propagation as jprop
from liso_tpu.tracker import refinement as jref
from liso_tpu.tracker import smoothing as jsmooth
from liso_tpu_torch.ops import boxes as tboxes
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.tracker import box_fitting as tfit
from liso_tpu_torch.tracker import dbs as tdbs
from liso_tpu_torch.tracker import mining as tmin
from liso_tpu_torch.tracker import propagation as tprop
from liso_tpu_torch.tracker import refinement as tref
from liso_tpu_torch.tracker import smoothing as tsmooth

torch.set_num_threads(1)
ATOL = 1e-5  # a few fp32 ops on values of order 10
FIT_ATOL = 1e-4  # extents over up to 300 points, angles at the same argmax
# Smoothing: Adam at lr 0.1 on a loss with a norm (an L1 term) does not
# settle: it keeps stepping about lr around the optimum, and a rounding
# difference grows from iteration to iteration (port against JAX: 1e-6 m
# after 20 steps, 2e-2 m after 80). The JAX function against ITSELF, its
# input moved by one ulp, differs by up to 0.068 m in position after 200
# steps on these tracks (0.061 after 2000). So: 20 steps held to rounding,
# 200 steps to the reference's own one-ulp spread.
SHORT_ITERS, SHORT_ATOL = 20, 1e-5
SMOOTH_POS_ATOL = 0.1  # m, after 200 steps
SMOOTH_YAW_ATOL = 0.1  # rad: the heading of displacements of >= 1 m
SMOOTH_VELO_ATOL = 2 * SMOOTH_POS_ATOL  # a displacement of two positions


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    return np.asarray(x)


def _frame(seed, n=2000, k=8):
    """Boxes around point clusters, plus background: (boxes dict, pcl,
    valid, flow, odom)."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-15, 15, (k, 3)).astype(np.float32)
    centers[:, 2] = -0.8
    pts = [rng.uniform(-18, 18, (n - 60 * k, 3))]
    for c in centers:
        pts.append(c + rng.uniform(-1, 1, (60, 3)) * [1.8, 0.8, 0.6])
    pcl = np.concatenate(pts).astype(np.float32)
    pcl = np.concatenate([pcl, rng.rand(n, 1).astype(np.float32)], -1)
    flow = (rng.randn(n, 3) * 0.3).astype(np.float32)
    flow[-60 * k:, 0] += 1.0
    yaw = rng.uniform(-np.pi, np.pi, (k, 1)).astype(np.float32)
    boxes = {
        "pos": centers, "dims": np.tile([[4.0, 2.0, 1.5]], (k, 1)).astype(np.float32),
        "rot": yaw, "probs": rng.rand(k, 1).astype(np.float32),
        "velo": np.zeros((k, 1), np.float32), "valid": rng.rand(k) > 0.2,
    }
    c, s = np.cos(0.03), np.sin(0.03)
    odom = np.array([[c, -s, 0, 0.6], [s, c, 0, 0.02], [0, 0, 1, 0],
                     [0, 0, 0, 1]], np.float32)
    return boxes, pcl, rng.rand(n) > 0.05, flow, odom


def test_propagation_and_yaw_alignment():
    d, pcl, valid, flow, odom = _frame(0)
    jb, tb = jboxes.boxes_from_numpy(d), tboxes.boxes_from_numpy(d)
    jp, jv, jf, jo = map(jnp.asarray, (pcl, valid, flow, odom))
    tp, tv, tf, to = map(_t, (pcl, valid, flow, odom))
    np.testing.assert_allclose(
        tprop.mean_flow_per_box(tb, tp, tv, tf).numpy(),
        _np(jprop.mean_flow_per_box(jb, jp, jv, jf)), atol=ATOL, rtol=0)
    want = jprop.propagate_boxes_with_flow(jb, jp, jv, jf, jo)
    got = tprop.propagate_boxes_with_flow(tb, tp, tv, tf, to)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tprop.box_motion_without_odometry(tb, got[0], got[1]).numpy(),
        _np(jprop.box_motion_without_odometry(jb, want[0], want[1])),
        atol=ATOL, rtol=0)
    ja = jprop.soft_align_yaw_with_motion(jb, want[0], want[1])
    ta = tprop.soft_align_yaw_with_motion(tb, got[0], got[1])
    np.testing.assert_allclose(ta.rot.numpy(), _np(ja.rot), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ta.velo.numpy(), _np(ja.velo), atol=ATOL, rtol=0)


@pytest.mark.parametrize("method", ["closeness_to_edge", "variance_to_edge",
                                    "min_area", "pca"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_2d_box(method, seed):
    rng = np.random.RandomState(seed)
    yaw = rng.uniform(-1.5, 1.5)
    n = 300
    t = rng.uniform(-1, 1, n)
    side = rng.randint(0, 4, n)
    x = np.where(side == 0, 2.0, np.where(side == 1, -2.0, t * 2.0))
    y = np.where(side < 2, t * 1.0, np.where(side == 2, 1.0, -1.0))
    x, y = x + 0.05 * rng.randn(n), y + 0.05 * rng.randn(n)
    c, s = np.cos(yaw), np.sin(yaw)
    pts = np.stack([c * x - s * y + 5.0, s * x + c * y - 3.0], -1).astype(np.float32)
    mask = rng.rand(n) > 0.1
    want = jfit.fit_2d_box(jnp.asarray(pts), jnp.asarray(mask), method=method)
    got = tfit.fit_2d_box(_t(pts), _t(mask), method=method)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=FIT_ATOL, rtol=0)


@pytest.mark.parametrize("fit", [(True, True), (False, True)])
def test_refine_track_boxes(fit):
    rng = np.random.RandomState(3)
    T = 6
    track = {
        "pos": np.stack([[2.0 + 1.2 * i, -1.0, -0.8] for i in range(T)]).astype(np.float32),
        "dims": (np.array([[4.0, 1.8, 1.5]]) + 0.3 * rng.randn(T, 3)).astype(np.float32),
        "rot": (0.3 + 0.05 * rng.randn(T, 1)).astype(np.float32),
        "probs": rng.rand(T, 1).astype(np.float32),
        "velo": np.zeros((T, 1), np.float32),
    }
    pcls = []
    for i in range(T):
        local = rng.uniform(-1, 1, (200, 3)) * [2.0, 0.9, 0.7]
        c, s = np.cos(0.25), np.sin(0.25)
        p = local @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T + track["pos"][i]
        bg = rng.uniform(-20, 20, (300, 3))
        pcls.append(np.concatenate([p, bg]).astype(np.float32))
    kw = dict(dims_quantile=0.8, fit_rot=fit[0], fit_pos=fit[1])
    want = jref.refine_track_boxes(track, pcls, **kw)
    got = tref.refine_track_boxes(track, pcls, device="cpu", **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=FIT_ATOL, rtol=0,
                                   err_msg=k)


def _track(rng, T):
    t = np.arange(T)
    pos = np.stack([1.5 * t + 0.2 * np.sin(t), 0.4 * t + 0.001 * t ** 2,
                    np.full(T, -0.8)], -1) + 0.15 * rng.randn(T, 3)
    yaw = np.arctan2(0.4, 1.5) + 0.1 * rng.randn(T, 1)
    return pos.astype(np.float32)[None], yaw.astype(np.float32)[None]


@pytest.mark.parametrize("iters", [SHORT_ITERS, 200])
@pytest.mark.parametrize("T", [4, 9, 23])
def test_smooth_track_jerk(T, iters):
    pos, yaw = _track(np.random.RandomState(T), T)
    valid = np.ones((1, T), bool)
    want = jsmooth.smooth_track_jerk(jnp.asarray(pos), jnp.asarray(valid),
                                     jnp.asarray(yaw), max_iters=iters)
    got = tsmooth.smooth_track_jerk(_t(pos), _t(valid), _t(yaw),
                                    max_iters=iters)
    short = iters == SHORT_ITERS
    for g, w, tol in zip(got, want, (SMOOTH_POS_ATOL, SMOOTH_YAW_ATOL,
                                     SMOOTH_VELO_ATOL)):
        np.testing.assert_allclose(g.numpy(), _np(w),
                                   atol=SHORT_ATOL if short else tol, rtol=0)
    if T > tsmooth.MIN_TRACK_LEN_FOR_SMOOTHING:  # it moved
        assert np.abs(got[0].numpy() - pos).max() > 1e-2


def test_reference_smoothing_spread():
    """Why SMOOTH_POS_ATOL is what it is: the JAX smoothing against itself
    with its input moved by one ulp, after 200 and 2000 steps, and the port
    against JAX after 20 and 80 steps (run with -s to see the numbers)."""
    spread = {200: 0.0, 2000: 0.0}
    for T in (9, 12, 23):
        pos, yaw = _track(np.random.RandomState(T), T)
        pos2 = np.nextafter(pos, np.float32(np.inf))
        valid = jnp.ones((1, T), bool)
        for iters in spread:
            a = jsmooth.smooth_track_jerk(jnp.asarray(pos), valid,
                                          jnp.asarray(yaw), max_iters=iters)
            b = jsmooth.smooth_track_jerk(jnp.asarray(pos2), valid,
                                          jnp.asarray(yaw), max_iters=iters)
            spread[iters] = max(spread[iters],
                                float(np.abs(_np(a[0]) - _np(b[0])).max()))
    pos, yaw = _track(np.random.RandomState(9), 9)
    growth = {}
    for iters in (SHORT_ITERS, 80):
        want = jsmooth.smooth_track_jerk(jnp.asarray(pos), jnp.ones((1, 9), bool),
                                         jnp.asarray(yaw), max_iters=iters)
        got = tsmooth.smooth_track_jerk(_t(pos), torch.ones(1, 9, dtype=torch.bool),
                                        _t(yaw), max_iters=iters)
        growth[iters] = float(np.abs(got[0].numpy() - _np(want[0])).max())
    print(f"reference one-ulp spread {spread} m; port vs JAX {growth} m")
    assert 1e-2 < spread[200] < SMOOTH_POS_ATOL
    assert 1e-2 < spread[2000] < SMOOTH_POS_ATOL
    assert growth[SHORT_ITERS] < SHORT_ATOL < 1e-3 < growth[80]


@pytest.mark.parametrize("iters", [SHORT_ITERS, 200])
@pytest.mark.parametrize("T", [3, 12])
def test_smooth_track_bike_model(T, iters):
    pos, yaw = _track(np.random.RandomState(10 + T), T)
    valid = np.ones((1, T), bool)
    vlen = np.array([4.0], np.float32)
    want = jsmooth.smooth_track_bike_model(
        jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(yaw),
        jnp.asarray(vlen), max_iters=iters)
    got = tsmooth.smooth_track_bike_model(_t(pos), _t(valid), _t(yaw),
                                          _t(vlen), max_iters=iters)
    short = iters == SHORT_ITERS
    for g, w, tol in zip(got, want, (SMOOTH_POS_ATOL, SMOOTH_YAW_ATOL,
                                     SMOOTH_VELO_ATOL)):
        np.testing.assert_allclose(g.numpy(), _np(w),
                                   atol=SHORT_ATOL if short else tol, rtol=0)


def test_mine_frame_device():
    d, pcl, valid, flow, odom = _frame(4)
    d["pos"][0, :2] = [19.5, 0.0]  # on the BEV border
    jbev, bev = JBev((40.0, 40.0), (64, 64)), BevSetup((40.0, 40.0), (64, 64))
    inv = np.linalg.inv(odom).astype(np.float32)
    for align in (False, True):
        want = jmin._mine_frame_device(
            jboxes.boxes_from_numpy(d), *map(jnp.asarray, (pcl, valid, flow, odom, inv)),
            jbev, 20, True, align)
        got = tmin._mine_frame_device(
            tboxes.boxes_from_numpy(d), *map(_t, (pcl, valid, flow, odom, inv)),
            bev, 20, True, align)
        v, det, st1, stm1 = tmin._frame_to_host(*got)
        np.testing.assert_array_equal(v, _np(want[0].valid))
        assert 0 < v.sum() < d["valid"].sum()
        for k in det:
            np.testing.assert_allclose(det[k], _np(getattr(want[0], k))[v],
                                       atol=ATOL, rtol=0)
        np.testing.assert_allclose(st1, _np(want[1]), atol=ATOL, rtol=0)
        np.testing.assert_allclose(stm1, _np(want[2]), atol=ATOL, rtol=0)


def test_union_proposals():
    rng = np.random.RandomState(5)
    p, s = _frame(5, k=10)[0], _frame(6, k=12)[0]
    s["pos"][:4] = p["pos"][:4] + 0.3  # duplicates of primary boxes
    want = jmin.union_proposals(jboxes.boxes_from_numpy(p),
                                jboxes.boxes_from_numpy(s), 1.0)
    got = tmin.union_proposals(tboxes.boxes_from_numpy(p),
                               tboxes.boxes_from_numpy(s), 1.0)
    for f in tboxes._FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(want, f)))
    assert rng is not None and int(got.valid.sum()) < p["valid"].sum() + s["valid"].sum()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_db_files_cross_load(tmp_path, writer):
    rng = np.random.RandomState(7)
    mined = {f"s{i}": {"lidar_T_box": rng.randn(2, 4, 4),
                       "raw_box": {"pos": rng.randn(2, 3).astype(np.float32)},
                       "track_id": np.array([i, i + 1])} for i in range(3)}
    augm = tdbs.empty_augm_db()
    for i in range(4):
        augm["pcl_in_box_cosy"].append(rng.randn(20, 4).astype(np.float32))
        augm["lidar_rows"].append(rng.randint(0, 64, 20))
        augm["boxes"].append({"pos": rng.randn(3).astype(np.float32),
                              "probs": np.float32([0.5 + 0.1 * i])})
        augm["box_T_sensor"].append(rng.randn(4, 4))
        augm["unique_track_id"].append(i)
    w, r = (jdbs, tdbs) if writer == "jax" else (tdbs, jdbs)
    loaded = r.load_mined_boxes_db(w.save_mined_boxes_db(mined, tmp_path / "tracked"))
    assert set(loaded) == set(mined)
    for k in mined:
        np.testing.assert_array_equal(loaded[k]["lidar_T_box"], mined[k]["lidar_T_box"])
        np.testing.assert_array_equal(loaded[k]["track_id"], mined[k]["track_id"])
    a = r.load_augm_db(w.save_augm_db(augm, tmp_path / "augm_db"))
    assert len(a["pcl_in_box_cosy"]) == 4
    np.testing.assert_array_equal(a["unique_track_id"], np.arange(4))
    np.testing.assert_array_equal(a["boxes"]["pos"],
                                  np.stack([b["pos"] for b in augm["boxes"]]))


def test_icp_native_copy_matches_numpy():
    from liso_tpu_torch.data import icp

    lib = icp._load_native()
    assert lib, "the port's copy of icp.cpp did not build"
    assert str(icp.NATIVE_SRC).startswith(str(icp.Path(icp.__file__).parent.parent))
    rng = np.random.RandomState(0)
    tgt = np.concatenate([
        rng.uniform(-20, 20, (3000, 3)) * [1, 1, 0.1],
        np.stack([np.full(500, 8.0), rng.uniform(-10, 10, 500),
                  rng.uniform(0, 3, 500)], -1),
        np.stack([rng.uniform(-10, 10, 500), np.full(500, -6.0),
                  rng.uniform(0, 3, 500)], -1),
    ])
    a = 0.03
    T_true = np.array([[np.cos(a), -np.sin(a), 0, 0.3],
                       [np.sin(a), np.cos(a), 0, -0.2], [0, 0, 1, 0.05],
                       [0, 0, 0, 1]])
    src = (tgt - T_true[:3, 3]) @ T_true[:3, :3]  # T_true @ src = tgt
    T_nat = icp.icp_register(src, tgt, np.eye(4), voxel=1.0, max_corr_dist=1.0)
    T_np = icp._icp_numpy(src, tgt, np.eye(4), 1.0, 30)
    np.testing.assert_allclose(T_nat, T_np, atol=1e-6)
    np.testing.assert_allclose(T_nat, T_true, atol=1e-6)
    ds_nat = icp.voxel_downsample(tgt, 1.0)
    keys = np.floor(tgt[:, :3] / 1.0).astype(np.int64)
    assert len(ds_nat) == len(np.unique(keys, axis=0))
