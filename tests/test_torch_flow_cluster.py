"""The flow-cluster bootstrap and its ops: liso_tpu_torch against liso_tpu
on the same seeded numpy inputs (CPU, fp32).

- ops/transforms.py and the pose / membership methods of ops/boxes.py;
- ops/clustering.py: connected_components (labels equal, also on a mask
  whose propagation hits the iteration cap) and cluster_stats (the same
  selected clusters and counts, moments within 1e-4 cells);
- models/flow_cluster_detector.py: detect_boxes_from_flow (the same valid
  slots, pos and dims within 1e-4 m, rot within 1e-4 rad);
- ops/soft_masks.py: soft_box_membership within 1e-6;
- data/centermaps.py: render_centermaps' per_obj_prob_scale.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from liso_tpu.data import centermaps as jcm
from liso_tpu.models import box_decode as jbd
from liso_tpu.models import flow_cluster_detector as jfc
from liso_tpu.ops import boxes as jboxes
from liso_tpu.ops import clustering as jcl
from liso_tpu.ops import soft_masks as jsm
from liso_tpu.ops import transforms as jtr
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu.ops.bev import point_cell_ids as j_cell_ids
from liso_tpu_torch.data import centermaps as tcm
from liso_tpu_torch.models import box_decode as tbd
from liso_tpu_torch.models import flow_cluster_detector as tfc
from liso_tpu_torch.ops import boxes as tboxes
from liso_tpu_torch.ops import clustering as tcl
from liso_tpu_torch.ops import soft_masks as tsm
from liso_tpu_torch.ops import transforms as ttr
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.ops.bev import point_cell_ids

torch.set_num_threads(1)
# fp32 on both sides; transforms and memberships are a few fp32 ops deep
ATOL = 1e-6
# box attributes of the detector: moments summed over up to ~1000 cells in
# another order, then a Kabsch SVD per box
BOX_ATOL = 1e-4
MOMENT_ATOL = 1e-4  # cells
BEV = (40.0, 128)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rand_boxes(rng, k, batch=()):
    d = {
        "pos": rng.uniform(-10, 10, batch + (k, 3)).astype(np.float32),
        "dims": rng.uniform(0.5, 5, batch + (k, 3)).astype(np.float32),
        "rot": rng.uniform(-np.pi, np.pi, batch + (k, 1)).astype(np.float32),
        "probs": rng.rand(*batch, k, 1).astype(np.float32),
        "velo": rng.randn(*batch, k, 1).astype(np.float32),
        "valid": rng.rand(*batch, k) > 0.3,
    }
    return d


def _poses(rng, n):
    T = np.zeros((n, 4, 4), np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n)
    T[:, 0, 0], T[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    T[:, 1, 0], T[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    T[:, 2, 2] = 1.0
    T[:, :3, 3] = rng.uniform(-5, 5, (n, 3))
    T[:, 3, 3] = 1.0
    return T


def _rotations(rng, n):
    """Random rotations, with the four branches of Shepperd's method each
    taken: near-identity and near pi turns about x, y and z."""
    q = rng.randn(n, 4)
    q[: n // 5, 0] += 10.0
    for ax in range(3):
        q[(ax + 1) * n // 5:(ax + 2) * n // 5, ax + 1] += 10.0
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], -1).reshape(n, 3, 3)
    return R.astype(np.float32)


@pytest.mark.parametrize("fn", [
    "rot_z", "compose_theta", "compose_R", "decompose", "invert_pose",
    "transform_points", "transform_flow", "normalize_angle",
    "matrix_to_quaternion",
])
def test_transforms(fn):
    rng = np.random.RandomState(0)
    T = _poses(rng, 6)
    pts = rng.uniform(-20, 20, (6, 50, 3)).astype(np.float32)
    theta = rng.uniform(-10, 10, (6, 5)).astype(np.float32)
    t = rng.randn(6, 5, 3).astype(np.float32)
    R = _rotations(rng, 40)
    cases = {
        "rot_z": lambda m, x: m.rot_z(x(theta)),
        "compose_theta": lambda m, x: m.compose_matrix(t=x(t), theta_z=x(theta)),
        "compose_R": lambda m, x: m.compose_matrix(t=x(t[:, 0]), R=x(T[:, :3, :3])),
        "decompose": lambda m, x: m.decompose_matrix(x(T)),
        "invert_pose": lambda m, x: m.invert_pose(x(T)),
        "transform_points": lambda m, x: m.transform_points(x(T), x(pts)),
        "transform_flow": lambda m, x: m.transform_flow(x(T), x(pts)),
        "normalize_angle": lambda m, x: m.normalize_angle(x(theta)),
        "matrix_to_quaternion": lambda m, x: m.matrix_to_quaternion(x(R)),
    }
    want = cases[fn](jtr, jnp.asarray)
    got = cases[fn](ttr, _t)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _np(w), atol=ATOL * 10 if fn in (
            "transform_points", "transform_flow") else ATOL, rtol=0)


@pytest.mark.parametrize("method", [
    "poses", "transform", "points_in_box_mask", "box_coords", "corners",
    "from_numpy", "mask_invalid", "batch_shape",
])
def test_boxes_methods(method):
    rng = np.random.RandomState(1)
    d = _rand_boxes(rng, 12, (2,))
    jb = jboxes.boxes_from_numpy(d)
    tb = tboxes.boxes_from_numpy(d)
    pcl = rng.uniform(-12, 12, (2, 2000, 3)).astype(np.float32)
    T = _poses(rng, 2)
    if method == "batch_shape":
        assert tuple(tb.batch_shape) == tuple(jb.batch_shape) == (2,)
        return
    if method == "from_numpy":
        for f in tboxes._FIELDS:
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          _np(getattr(jb, f)))
        return
    if method == "mask_invalid":
        for f in tboxes._FIELDS:
            np.testing.assert_array_equal(
                getattr(tb.mask_invalid(), f).numpy(),
                _np(getattr(jb.mask_invalid(), f)))
        return
    if method == "points_in_box_mask":
        got = tb.points_in_box_mask(_t(pcl), bloat=1.1).numpy()
        want = _np(jb.points_in_box_mask(jnp.asarray(pcl), bloat=1.1))
        # a point within fp32 noise of a face may fall on either side
        assert (got != want).sum() <= 2 and got.sum() > 50
        return
    if method == "box_coords":
        _, got = tb.points_in_box_mask(_t(pcl), return_box_coords=True)
        _, want = jb.points_in_box_mask(jnp.asarray(pcl), return_box_coords=True)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)
        return
    if method == "transform":
        got, want = tb.transform(_t(T)), jb.transform(jnp.asarray(T))
        for f in ("pos", "rot", "dims"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       _np(getattr(want, f)), atol=1e-5, rtol=0)
        return
    got, want = getattr(tb, method)(), getattr(jb, method)()
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)


def _blob_mask(rng, h, w, n_blobs, p=0.6):
    m = np.zeros((h, w), bool)
    for _ in range(n_blobs):
        r, c = rng.randint(0, h), rng.randint(0, w)
        rr, cc = rng.randint(1, 8), rng.randint(1, 8)
        m[r:r + rr, c:c + cc] |= rng.rand(min(rr, h - r), min(cc, w - c)) < p
    return m


def _snake(h, w):
    """One cluster whose min label needs about h * w / 4 propagations:
    a serpentine corridor of every other row."""
    m = np.zeros((h, w), bool)
    m[::4, :] = True
    for r in range(0, h - 4, 4):
        col = w - 1 if (r // 4) % 2 == 0 else 0
        m[r:r + 5, col] = True
    return m


@pytest.mark.parametrize("case", [
    "blobs_d2", "blobs_d1", "blobs_d0", "dense_d2", "empty", "snake_cap",
    "snake_converges",
])
def test_connected_components(case):
    rng = np.random.RandomState(2)
    dilation, max_iters = 2, 256
    if case.startswith("blobs"):
        mask = _blob_mask(rng, 96, 80, 25)
        dilation = int(case[-1])
    elif case == "dense_d2":
        mask = rng.rand(64, 64) < 0.15
    elif case == "empty":
        mask = np.zeros((32, 48), bool)
    else:
        mask = _snake(64, 24)
        dilation = 0
        # the snake needs about 400 propagations: 37 stops mid-way, at a
        # count that is no multiple of the port's check interval
        max_iters = 37 if case == "snake_cap" else 1000
    want = _np(jcl.connected_components(jnp.asarray(mask), dilation=dilation,
                                        max_iters=max_iters))
    got = tcl.connected_components(_t(mask), dilation=dilation,
                                   max_iters=max_iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "snake_cap":  # not converged: more than one label remains
        assert len(np.unique(want[mask])) > 1
    if case == "snake_converges":
        assert len(np.unique(want[mask])) == 1


@pytest.mark.parametrize("k_max", [8, 64])
def test_cluster_stats(k_max):
    rng = np.random.RandomState(3)
    mask = _blob_mask(rng, 96, 96, 30)
    labels = _np(jcl.connected_components(jnp.asarray(mask), dilation=1))
    want = jcl.cluster_stats(jnp.asarray(labels), k_max=k_max)
    got = tcl.cluster_stats(_t(labels), k_max=k_max)
    np.testing.assert_array_equal(got.valid.numpy(), _np(want.valid))
    np.testing.assert_array_equal(got.count.numpy(), _np(want.count))
    assert int(got.valid.sum()) == min(k_max, len(np.unique(labels)) - 1)
    v = _np(want.valid)
    for f in ("centroid_rc", "axis_major", "axis_minor"):
        np.testing.assert_allclose(getattr(got, f).numpy()[v],
                                   _np(getattr(want, f))[v], atol=MOMENT_ATOL,
                                   rtol=0)
    # the orientation of a round cluster is ill-conditioned: compare it
    # where the two axes differ
    elong = v & (_np(want.axis_major) > _np(want.axis_minor) + 0.5)
    np.testing.assert_allclose(got.orientation.numpy()[elong],
                               _np(want.orientation)[elong], atol=1e-4, rtol=0)


def _flow_scene(seed, n=4096, n_obj=3):
    """A frame of background and n_obj moving box-shaped objects, with
    ego motion: (pcl [N, 4], valid, flow [N, 3], odom [4, 4])."""
    rng = np.random.RandomState(seed)
    n_pts = 300
    bg = rng.uniform(-18, 18, (n - n_obj * n_pts, 3))
    bg[:, 2] = rng.uniform(-1.6, 0.3, len(bg))
    odom = _poses(rng, 1)[0].astype(np.float64)
    odom[:3, :3] = np.array([[np.cos(0.02), -np.sin(0.02), 0],
                             [np.sin(0.02), np.cos(0.02), 0], [0, 0, 1]])
    odom[:3, 3] = [0.5, 0.05, 0.0]
    inv = np.linalg.inv(odom)
    objs, flows = [], []
    for i in range(n_obj):
        c = rng.uniform(-12, 12, 3)
        c[2] = -0.8
        yaw = rng.uniform(-np.pi, np.pi)
        local = rng.uniform(-1, 1, (n_pts, 3)) * [2.0, 0.9, 0.7]
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                      [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        p = local @ R.T + c
        v = 1.2 * np.array([np.cos(yaw), np.sin(yaw), 0.0])
        objs.append(p)
        # flow = rigid ego flow + the object's own motion
        flows.append(p @ inv[:3, :3].T + inv[:3, 3] - p + v)
    bg_flow = bg @ inv[:3, :3].T + inv[:3, 3] - bg
    pcl = np.concatenate([bg, *objs])
    flow = np.concatenate([bg_flow, *flows])
    pcl = np.concatenate([pcl, rng.rand(n, 1)], -1).astype(np.float32)
    valid = rng.rand(n) > 0.02
    return pcl, valid, flow.astype(np.float32), odom.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_detect_boxes_from_flow(seed):
    pcl, valid, flow, odom = _flow_scene(seed)
    jbev = JBev((BEV[0], BEV[0]), (BEV[1], BEV[1]))
    bev = BevSetup((BEV[0], BEV[0]), (BEV[1], BEV[1]))
    cfg_j = jfc.FlowClusterCfg(k_max=16)
    cfg_t = tfc.FlowClusterCfg(k_max=16)
    jp, jv = jnp.asarray(pcl), jnp.asarray(valid)
    jcell, _, _ = j_cell_ids(jp[:, :2], jbev, jv)
    want = jfc.detect_boxes_from_flow(
        jp, jv, jcell, jnp.asarray(flow), jnp.asarray(odom), jp, jv,
        jnp.asarray(0.1), jbev, cfg_j)
    tp, tv = _t(pcl), _t(valid)
    tcell, _, _ = point_cell_ids(tp[:, :2], bev, tv)
    got = tfc.detect_boxes_from_flow(tp, tv, tcell, _t(flow), _t(odom), tp, tv,
                                     0.1, bev, cfg_t)
    v = _np(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert v.sum() >= 2
    for f, tol in (("pos", BOX_ATOL), ("dims", BOX_ATOL), ("rot", BOX_ATOL),
                   ("velo", BOX_ATOL), ("probs", 0.0)):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   _np(getattr(want, f)), atol=tol, rtol=0,
                                   err_msg=f)
    # the dynamicness grid on its own
    dj, fj = jfc.bev_dynamicness_and_flow(jp, jv, jcell, jnp.asarray(flow),
                                          jnp.asarray(odom), jbev)
    dt, ft = tfc.bev_dynamicness_and_flow(tp, tv, tcell, _t(flow), _t(odom), bev)
    np.testing.assert_allclose(dt.numpy(), _np(dj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ft.numpy(), _np(fj), atol=1e-5, rtol=0)


@pytest.mark.parametrize("softness", ["cauchy", "sigmoid"])
def test_soft_box_membership(softness):
    rng = np.random.RandomState(4)
    d = _rand_boxes(rng, 10, (2,))
    pts = rng.uniform(-12, 12, (2, 300, 3)).astype(np.float32)
    want = jsm.soft_box_membership(jboxes.boxes_from_numpy(d), jnp.asarray(pts),
                                   sigmoid_slope=5.0, softness_fun=softness)
    got = tsm.soft_box_membership(tboxes.boxes_from_numpy(d), _t(pts),
                                  sigmoid_slope=5.0, softness_fun=softness)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    assert float(got.max()) > 0.5


def test_render_centermaps_per_obj_prob_scale():
    rng = np.random.RandomState(5)
    d = _rand_boxes(rng, 6, (2,))
    d["pos"][..., :2] *= 1.5
    scale = rng.uniform(0.2, 1.0, (2, 6, 1)).astype(np.float32)
    jb = JBev((40.0, 40.0), (64, 64))
    tbev = BevSetup((40.0, 40.0), (64, 64))
    want = jcm.render_centermaps(jboxes.boxes_from_numpy(d), jb, (16, 16),
                                 jbd.BoxPredictionCfg(),
                                 per_obj_prob_scale=jnp.asarray(scale))
    got = tcm.render_centermaps(tboxes.boxes_from_numpy(d), tbev, (16, 16),
                                tbd.BoxPredictionCfg(),
                                per_obj_prob_scale=_t(scale))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy().astype(np.float32),
                                   _np(want[k]).astype(np.float32), atol=1e-5,
                                   rtol=0, err_msg=k)
    plain = tcm.render_centermaps(tboxes.boxes_from_numpy(d), tbev, (16, 16),
                                  tbd.BoxPredictionCfg())
    assert not torch.equal(plain["probs"], got["probs"])
