"""PointPillars in the port against the JAX package
(liso_tpu/models/pointpillars.py, liso_tpu/train/pointpillars_train.py),
fp32, grid 64 over 40 m (a 16 x 16 head grid, 8 anchors a cell), batch 2,
1024 points per frame, 8 target slots: the anchors, the delta encoding,
`assign_targets`, the loss, the net, and PointPillarsTrainer's train and
predict steps from random flax weights carried across by
liso_tpu_torch.weights.

Tolerances: forward maps 1e-4; labels and matched GT slots equal; loss
terms 1e-4; gradients 3e-2 of each tensor's norm (as the detector step);
predicted boxes 1e-4 with the same kept set.

The reference's force-match scatters every GT row: a padded row, whose
best anchor is anchor 0, writes False to anchor 0 after a valid GT may
have set it (liso_tpu/models/pointpillars.py:157-158). The port scatters
only the valid rows. `test_reference_fault_force_match_at_anchor_0` shows
both; the parity tests assert that JAX gives the same targets without the
padded rows on their data.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.models import pointpillars as jpp
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu.ops.boxes import Boxes as JBoxes
from liso_tpu.train.pointpillars_train import PointPillarsTrainer as JTrainer
from liso_tpu.train.pointpillars_train import PPTrainState
from liso_tpu_torch.models import pointpillars as tpp
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.train.pointpillars_train import PointPillarsTrainer
from liso_tpu_torch.weights import (
    flax_state_dict,
    load_detector_train_state,
    load_flax_variables,
)
from test_torch_detector_modules import both, random_boxes
from test_torch_detector_train import _as_port, _batch, _np, _rel
from test_torch_modules import random_variables

torch.set_num_threads(1)
GRID, RANGE, HEAD = 64, 40.0, 16
MAP_ATOL = LOSS_RTOL = BOX_ATOL = 1e-4
GRAD_REL = 3e-2
CFG = dict(max_lr=1e-5, total_steps=100, post_max_boxes=40)


def _t(x):
    return torch.from_numpy(np.array(x))


def _anchors():
    a = jpp.make_anchors(JBev((RANGE, RANGE), (GRID, GRID)), (HEAD, HEAD),
                         jpp.AnchorCfg())
    return a.reshape(-1, 7)


def test_make_anchors():
    for hw in ((HEAD, HEAD), (12, 20)):
        want = jpp.make_anchors(JBev((RANGE, 30.0), (GRID, 80)), hw, jpp.AnchorCfg())
        got = tpp.make_anchors(BevSetup((RANGE, 30.0), (GRID, 80)), hw, tpp.AnchorCfg())
        np.testing.assert_array_equal(got, want)


def test_encode_decode_round_trip():
    rng = np.random.RandomState(1)
    anchors = _anchors()[rng.choice(HEAD * HEAD * 8, 300)]
    gt = np.concatenate([
        anchors[:, :3] + rng.uniform(-2, 2, (300, 3)),
        anchors[:, 3:6] * rng.uniform(0.5, 2.0, (300, 3)),
        rng.uniform(-1.5, 1.5, (300, 1)),
    ], -1).astype(np.float32)
    want = np.asarray(jpp.encode_deltas(jnp.asarray(gt), jnp.asarray(anchors)))
    got = tpp.encode_deltas(_t(gt), _t(anchors))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    back = tpp.decode_deltas(got, _t(anchors))
    np.testing.assert_allclose(back.numpy(), gt, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(
        back.numpy(),
        np.asarray(jpp.decode_deltas(jnp.asarray(want), jnp.asarray(anchors))),
        atol=1e-5, rtol=1e-6)


def _gt(seed, b=2, k=8, n_valid=3):
    """GT boxes of car and pedestrian sizes over the grid's interior (not
    at its corner cell), valid slots first."""
    rng = np.random.RandomState(seed)
    d = random_boxes(rng, b, k, valid_frac=1.0, spread=15.0)
    d["dims"][:, ::2] = rng.uniform([3.5, 1.5, 1.4], [5.0, 2.0, 1.8], (b, (k + 1) // 2, 3))
    d["rot"] = rng.choice([0.0, np.pi / 2, 0.3], (b, k, 1)).astype(np.float32)
    d["valid"][:, n_valid:] = False
    return d


def _assign_jax(gt, anchors):
    jg, _ = both(gt)
    fn = jax.jit(jax.vmap(lambda g: jpp.assign_targets(g, anchors, jpp.AnchorCfg())))
    return [np.asarray(x) for x in fn(jg)]


@pytest.mark.parametrize("seed", [2, 3])
def test_assign_targets(seed):
    gt, anchors = _gt(seed), _anchors()
    want_labels, want_gt = _assign_jax(gt, jnp.asarray(anchors))
    # the reference's fault does not fire on this data
    unpadded = _assign_jax({k: v[:, :3] for k, v in gt.items()}, jnp.asarray(anchors))
    np.testing.assert_array_equal(unpadded[0], want_labels)
    got_labels, got_gt = tpp.assign_targets(both(gt)[1], _t(anchors), tpp.AnchorCfg())
    np.testing.assert_array_equal(got_labels.numpy(), want_labels)
    np.testing.assert_array_equal(got_gt.numpy(), want_gt)
    assert (want_labels == 1).sum() >= 6
    _assert_no_best_anchor_tie(gt, anchors)


def test_anchor_gt_iou_equals_the_dense_matrix():
    """The pairs the port skips have IoU 0 in the dense matrix too."""
    from liso_tpu_torch.ops.iou import iou_matrix_bev

    gt, anchors = _gt(4), _anchors()
    _, tg = both(gt)
    got = tpp.anchor_gt_iou(_t(anchors), tg)
    for i in range(2):
        a = _t(anchors)
        want = iou_matrix_bev(a[:, :3], a[:, 3:6], a[:, 6:7], tg.pos[i],
                              tg.dims[i], tg.rot[i], None, tg.valid[i])
        np.testing.assert_array_equal(got[i].numpy(), want.numpy())
    assert int((got > 0).sum()) > 50


def test_reference_fault_force_match_at_anchor_0():
    """A valid GT whose best anchor is anchor 0 (the grid's corner cell,
    one anchor a cell) with IoU below neg_iou: JAX's padded row clears the
    force-match, so JAX labels the anchor negative; without the padding
    JAX forces it positive, as the port does with or without it."""
    cfg_j = jpp.AnchorCfg(sizes=((3.9, 1.6, 1.56),), rotations=(0.0,))
    cfg_t = tpp.AnchorCfg(sizes=((3.9, 1.6, 1.56),), rotations=(0.0,))
    anchors = jpp.make_anchors(JBev((RANGE, RANGE), (GRID, GRID)), (HEAD, HEAD),
                               cfg_j).reshape(-1, 7)
    gt = {"pos": np.zeros((1, 3, 3), np.float32),
          "dims": np.tile(np.float32([3.9, 1.6, 1.56]), (1, 3, 1)),
          "rot": np.zeros((1, 3, 1), np.float32),
          "probs": np.ones((1, 3, 1), np.float32),
          "valid": np.array([[True, False, False]])}
    gt["pos"][0, 0] = [anchors[0, 0], anchors[0, 1], -1.0]
    gt["rot"][0, 0] = 1.2  # turned away: IoU with anchor 0 below 0.45

    def jax_labels(g):
        jg, _ = both(g)
        fn = jax.jit(jax.vmap(
            lambda b: jpp.assign_targets(b, jnp.asarray(anchors), cfg_j)))
        return np.asarray(fn(jg)[0])

    with_pad = jax_labels(gt)
    without = jax_labels({k: v[:, :1] for k, v in gt.items()})
    assert without[0, 0] == 1 and with_pad[0, 0] == 0
    assert (without[0, 1:] == with_pad[0, 1:]).all()
    for g in (gt, {k: v[:, :1] for k, v in gt.items()}):
        labels, matched = tpp.assign_targets(both(g)[1], _t(anchors), cfg_t)
        np.testing.assert_array_equal(labels.numpy(), without)
        assert int(matched[0, 0]) == 0


def test_pointpillars_loss():
    gt, anchors = _gt(5), _anchors()
    n = len(anchors)
    rng = np.random.RandomState(6)
    cls = rng.randn(2, n).astype(np.float32)
    reg = (0.3 * rng.randn(2, n, 7)).astype(np.float32)
    direction = rng.randn(2, n, 2).astype(np.float32)
    jg, tg = both(gt)
    want = jax.jit(jax.vmap(lambda c, r, d, g: jpp.pointpillars_loss(
        c, r, d, jnp.asarray(anchors), g, jpp.AnchorCfg())))(
        jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(direction), jg)
    got = tpp.pointpillars_loss(_t(cls), _t(reg), _t(direction), _t(anchors),
                                tg, tpp.AnchorCfg())
    assert set(got) == set(want) == {"cls", "reg", "dir"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


def _cloud(seed, n=1024, b=2):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-19, 19, (b, n, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 1, (b, n))
    return pts, rng.rand(b, n) > 0.05


def test_pointpillars_net():
    pts, valid = _cloud(7)
    jm = jpp.PointPillarsNet(JBev((RANGE, RANGE), (GRID, GRID)))
    v = random_variables(jm.init, jnp.asarray(pts), jnp.asarray(valid), seed=8)
    want = jax.jit(jm.apply)(v, jnp.asarray(pts), jnp.asarray(valid))
    tm = load_flax_variables(tpp.PointPillarsNet(BevSetup((RANGE, RANGE), (GRID, GRID))), v)
    tm.eval()
    with torch.no_grad():
        got = tm(_t(pts), _t(valid))
    for g, w, name in zip(got, want, ("cls", "reg", "dir", "occupancy")):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=MAP_ATOL,
                                   rtol=MAP_ATOL, err_msg=name)


# The force-match takes each GT's best anchor; where two anchors' IoUs lie
# within fp32 noise of each other the choice is a rounding (JAX itself
# picks the other one under jit than eagerly on the detector test's scene,
# whose first object sits 1 ulp nearer one of two cells). The step's scene
# is that scene moved by SHIFT_M, and every test's data holds a gap of at
# least BEST_GAP between each GT's best and second-best anchor.
SHIFT_M, BEST_GAP = 0.37, 1e-3


def _assert_no_best_anchor_tie(gt, anchors):
    iou = tpp.anchor_gt_iou(_t(anchors), both(gt)[1])
    top2 = iou.topk(2, dim=1).values
    gap = (top2[:, 0] - top2[:, 1])[_t(gt["valid"])]
    assert float(gap.min()) > BEST_GAP


def _pp_batch():
    pts, valid, boxes = _batch()
    pts[..., :2] += SHIFT_M
    boxes["pos"][..., :2] += SHIFT_M
    return pts, valid, boxes


@pytest.fixture(scope="module")
def runs():
    """Two JAX train steps from a random state and predict_step from the
    last; the port from each JAX state."""
    pts, valid, boxes = _pp_batch()
    jt = JTrainer(JBev((RANGE, RANGE), (GRID, GRID)), **CFG)
    jp, jv = jnp.asarray(pts), jnp.asarray(valid)
    jboxes = JBoxes(**{k: jnp.asarray(v) for k, v in boxes.items()})
    v = random_variables(jt.model.init, jp, jv, seed=51)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state0 = PPTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
        opt_state=jt.tx.init(params))
    fresh = lambda s: jax.tree_util.tree_map(jnp.asarray, s)
    jstates, jmetrics = [_np(state0)], []
    for _ in range(2):
        st, m = jt.train_step(fresh(jstates[-1]), jp, jv, jboxes)
        jstates.append(_np(st))
        jmetrics.append({k: float(x) for k, x in m.items()})
    jpred = _np(jt.predict_step(fresh(jstates[-1]), jp, jv))
    anchors = jt.anchors_flat((HEAD, HEAD))
    n_valid = int(boxes["valid"].sum(1).max())
    fault_free = (_assign_jax(boxes, anchors)[0],
                  _assign_jax({k: x[:, :n_valid] for k, x in boxes.items()},
                              anchors)[0])

    tt = PointPillarsTrainer(BevSetup((RANGE, RANGE), (GRID, GRID)),
                             device="cpu", **CFG)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(valid)
    tboxes = Boxes(**{k: torch.from_numpy(x) for k, x in boxes.items()})
    synced = []
    for k in range(2):
        load_detector_train_state(tt, _as_port(jstates[k]))
        m = tt.train_step(tp, tv, tboxes)
        synced.append(dict(
            metrics={n: float(x) for n, x in m.items()},
            grads={n: p.grad.clone() for n, p in tt.params.items()},
            step=tt.step, count=tt.count))
    load_detector_train_state(tt, _as_port(jstates[-1]))
    tpred = tt.predict_step(tp, tv)

    def moment(s):
        return flax_state_dict(tt.model, {"params": s.opt_state[0].mu})

    jgrads = [{k: (moment(b)[k] - 0.9 * moment(a)[k]) / 0.1 for k in moment(a)}
              for a, b in zip(jstates[:-1], jstates[1:])]
    return dict(jmetrics=jmetrics, jgrads=jgrads, jpred=jpred, tpred=tpred,
                synced=synced, fault_free=fault_free, jstates=jstates)


def test_step_data_does_not_fire_the_reference_fault(runs):
    padded, unpadded = runs["fault_free"]
    np.testing.assert_array_equal(padded, unpadded)
    assert (padded == 1).sum() > 0
    _assert_no_best_anchor_tie(_pp_batch()[2], _anchors())


@pytest.mark.parametrize("step", range(2))
def test_train_step(runs, step):
    """Loss terms, total and learning rate from the same JAX state; the
    step and the optimizer's count after it; every gradient."""
    got, want = runs["synced"][step]["metrics"], runs["jmetrics"][step]
    assert set(got) == set(want) == {"loss/cls", "loss/reg", "loss/dir",
                                     "loss/total", "lr"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    jst = runs["jstates"][step + 1]
    assert runs["synced"][step]["step"] == int(jst.step) == step + 1
    assert runs["synced"][step]["count"] == int(jst.opt_state[0].count)
    g, w = runs["synced"][step]["grads"], runs["jgrads"][step]
    assert set(g) == set(w)
    bad = {k: _rel(g[k], w[k]) for k in w if not _rel(g[k], w[k]) <= GRAD_REL}
    assert not bad, bad


def test_predict_step(runs):
    got, want = runs["tpred"], runs["jpred"]
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    assert int(got.valid.sum()) > 0
    for f in ("pos", "dims", "rot", "probs"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f),
                                   atol=BOX_ATOL, rtol=BOX_ATOL, err_msg=f)
