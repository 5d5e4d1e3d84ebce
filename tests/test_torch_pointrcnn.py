"""PointRCNN in the port against the JAX package
(liso_tpu/ops/ball_query.py, liso_tpu/models/pointrcnn.py,
liso_tpu/train/pointrcnn_train.py), fp32, grid 64 over 40 m, batch 2, 1024
points per frame, 8 target slots: `grid_ball_query`, `SetAbstraction`,
the net, the loss, and PointRCNNTrainer's train and predict steps from
random flax weights carried across by liso_tpu_torch.weights.

Tolerances: the ball query's neighbour sets equal (as sets, with the masks
equal); forward values 1e-4 and the same proposal indices; loss terms
1e-4; gradients 3e-2 of each tensor's norm (as the detector step), the
backbone's BatchNorm shifts 7e-2 (BN_SHIFT_REL);
predicted boxes 1e-4 with the same kept set.

Both stages' Hungarian terms carry the reference's duplicate-index fault
(tests/test_torch_transfusion.py): the parity tests assert that JAX gives
the same loss without the padded GT rows on their data.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.models import pointrcnn as jpr
from liso_tpu.ops.ball_query import grid_ball_query as j_ball_query
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu.ops.boxes import Boxes as JBoxes
from liso_tpu.train.pointrcnn_train import PointRCNNTrainer as JTrainer
from liso_tpu.train.pointrcnn_train import PRTrainState
from liso_tpu_torch.models import pointrcnn as tpr
from liso_tpu_torch.ops.ball_query import grid_ball_query
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.train.pointrcnn_train import PointRCNNTrainer
from liso_tpu_torch.weights import (
    flax_state_dict,
    load_detector_train_state,
    load_flax_variables,
)
from test_torch_detector_train import _as_port, _batch, _np, _rel
from test_torch_modules import random_variables

torch.set_num_threads(1)
GRID, RANGE = 64, 40.0
MAP_ATOL = LOSS_RTOL = BOX_ATOL = 1e-4
GRAD_REL = 3e-2
# The backbone's BatchNorm shifts reach the loss only through the point
# gathers of a sparse BEV map, and each is a sum of cotangents that the
# next BatchNorm made mean-free: near 0 in exact arithmetic, so fp32
# rounding is a large part of it. The port against ITSELF at 1 and 4 CPU
# threads differs by up to 3.3e-2 of such a tensor's norm (4.4e-2 on this
# net without the third target box); they are held to twice that.
BN_SHIFT_REL = 7e-2
CFG = dict(max_lr=1e-5, total_steps=100, post_max_boxes=40)
BOX_FIELDS = ("pos", "dims", "rot", "probs", "valid")


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud(seed, n=1024, b=2):
    """Uniform points, a dense cluster (cells holding more than the
    per-cell cap), duplicates, points off the grid and invalid ones."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-19, 19, (b, n, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 1, (b, n))
    pts[:, :200, :3] = rng.uniform(-1.5, 1.5, (b, 200, 3)) + [4.0, -3.0, 0.0]
    pts[:, 200:210] = pts[:, 210:220]
    pts[:, 220:230, 0] = 25.0
    return pts, rng.rand(b, n) > 0.05


@pytest.mark.parametrize("radius,k", [(1.0, 16), (2.5, 16), (1.0, 4)])
def test_grid_ball_query(radius, k):
    pts, valid = _cloud(1)
    fn = jax.jit(jax.vmap(lambda p, v: j_ball_query(
        p, v, radius=radius, k=k, bev_range_m=(RANGE, RANGE))))
    want_idx, want_mask = (np.asarray(x) for x in fn(jnp.asarray(pts), jnp.asarray(valid)))
    idx, mask = grid_ball_query(_t(pts), _t(valid), radius=radius, k=k,
                                bev_range_m=(RANGE, RANGE))
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    got_sets = np.where(mask.numpy(), idx.numpy(), -1)
    want_sets = np.where(want_mask, want_idx, -1)
    np.testing.assert_array_equal(np.sort(got_sets, -1), np.sort(want_sets, -1))
    assert want_mask.all(-1).sum() > 100 and (~want_mask).all(-1).sum() > 0


def test_set_abstraction():
    pts, valid = _cloud(2)
    bev = ((RANGE, RANGE), (GRID, GRID))
    feats = np.random.RandomState(3).randn(2, len(pts[0]), 8).astype(np.float32)
    jm = jpr.SetAbstraction(JBev(*bev), radius=1.0, k=8, out_dim=16)
    args = (jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(feats))
    v = random_variables(jm.init, *args, seed=4)
    want = jax.jit(jm.apply)(v, *args)
    tm = load_flax_variables(
        tpr.SetAbstraction(BevSetup(*bev), 1.0, in_dim=12, k=8, out_dim=16), v)
    with torch.no_grad():
        got = tm(_t(pts), _t(valid), _t(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MAP_ATOL,
                               rtol=MAP_ATOL)


def _pr_batch(centers):
    """The detector test's scene with a third target box in each sample at
    `centers` [(x, y), (x, y)]: near the proposals of the random net (which
    gathers them at a corner of the cloud), so that both stages' Hungarian
    terms have matches, though none with the first proposal."""
    pts, valid, boxes = _batch()
    for i, (x, y) in enumerate(centers):
        boxes["pos"][i, 2] = [x, y, -1.0]
        boxes["dims"][i, 2] = [4.0, 2.0, 1.5]
        boxes["rot"][i, 2] = 0.1
        boxes["probs"][i, 2] = 1.0
        boxes["valid"][i, 2] = True
    return pts, valid, boxes


def _proposal_idx(fg_logit, valid, k):
    score = torch.where(_t(valid), _t(fg_logit), -torch.inf)
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :k]


def _assert_boxes(got: Boxes, want, what):
    for f in BOX_FIELDS:
        g, w = getattr(got, f).detach().numpy(), np.asarray(getattr(want, f))
        if f == "valid":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")
        else:
            np.testing.assert_allclose(g, w, atol=MAP_ATOL, rtol=MAP_ATOL,
                                       err_msg=f"{what} {f}")


@pytest.fixture(scope="module")
def net_pair():
    """The JAX net's eval forward and the port's from the same random
    variables."""
    pts, valid, boxes = _pr_batch([(18.5, -11.5), (18.9, -12.2)])
    jm = jpr.PointRCNNNet(JBev((RANGE, RANGE), (GRID, GRID)))
    v = random_variables(jm.init, jnp.asarray(pts), jnp.asarray(valid), seed=9)
    want = jax.jit(jm.apply)(v, jnp.asarray(pts), jnp.asarray(valid))
    tm = load_flax_variables(tpr.PointRCNNNet(BevSetup((RANGE, RANGE), (GRID, GRID))), v)
    tm.eval()
    got = tm(_t(pts), _t(valid))
    return pts, valid, boxes, want, got


def test_pointrcnn_net(net_pair):
    pts, valid, _, want, got = net_pair
    np.testing.assert_allclose(got["fg_logit"].detach().numpy(), want["fg_logit"],
                               atol=MAP_ATOL, rtol=MAP_ATOL)
    np.testing.assert_array_equal(_proposal_idx(got["fg_logit"].detach(), valid, 128),
                                  jax.lax.top_k(jnp.where(jnp.asarray(valid),
                                                          want["fg_logit"], -jnp.inf),
                                                128)[1])
    _assert_boxes(got["proposals"], want["proposals"], "proposals")
    _assert_boxes(got["refined"], want["refined"], "refined")
    np.testing.assert_array_equal(got["occupancy"].numpy(), want["occupancy"])


def _jax_loss(out, pts, valid, boxes):
    gt = JBoxes(**{k: jnp.asarray(v) for k, v in boxes.items()})
    fn = jax.jit(lambda o: jpr.pointrcnn_loss(o, jnp.asarray(pts),
                                              jnp.asarray(valid), gt)[1])
    return {k: float(v) for k, v in fn(out).items()}


def test_pointrcnn_loss(net_pair):
    """Every term of the loss on each side's own forward; JAX's without
    the padded GT rows is the same (the fault does not fire here)."""
    pts, valid, boxes, want_out, got_out = net_pair
    want = _jax_loss(want_out, pts, valid, boxes)
    n_valid = int(boxes["valid"].sum(1).max())
    unpadded = _jax_loss(want_out, pts, valid,
                         {k: v[:, :n_valid] for k, v in boxes.items()})
    assert unpadded == pytest.approx(want, rel=1e-6)
    total, got = tpr.pointrcnn_loss(
        got_out, _t(pts), _t(valid), Boxes(**{k: _t(v) for k, v in boxes.items()}))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), want[k],
                                   rtol=LOSS_RTOL, err_msg=k)
    assert want["proposals_pos"] > 0 and want["refined_pos"] > 0
    np.testing.assert_allclose(float(total), sum(want.values()), rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def runs():
    """Two JAX train steps from a random state and predict_step from the
    last; the port from each JAX state."""
    pts, valid, boxes = _pr_batch([(-17.0, 18.0), (-17.6, 17.0)])
    jt = JTrainer(JBev((RANGE, RANGE), (GRID, GRID)), **CFG)
    jp, jv = jnp.asarray(pts), jnp.asarray(valid)
    jboxes = JBoxes(**{k: jnp.asarray(v) for k, v in boxes.items()})
    v = random_variables(jt.model.init, jp, jv, seed=61)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state0 = PRTrainState(
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
    n_valid = int(boxes["valid"].sum(1).max())
    unpadded = JBoxes(**{k: jnp.asarray(x[:, :n_valid]) for k, x in boxes.items()})

    def jax_terms(s, gt):
        out, _ = jt._forward(s.params, s.batch_stats, jp, jv, True)
        return jpr.pointrcnn_loss(out, jp, jv, gt)[1]

    terms = jax.jit(jax_terms)
    fault_free = [({k: float(x) for k, x in terms(fresh(s), jboxes).items()},
                   {k: float(x) for k, x in terms(fresh(s), unpadded).items()})
                  for s in jstates[:2]]

    tt = PointRCNNTrainer(BevSetup((RANGE, RANGE), (GRID, GRID)),
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
    for padded, unpadded in runs["fault_free"]:
        assert padded == pytest.approx(unpadded, rel=1e-6)
        assert padded["proposals_pos"] > 0 and padded["refined_pos"] > 0


@pytest.mark.parametrize("step", range(2))
def test_train_step(runs, step):
    """Every loss term, the total and the learning rate from the same JAX
    state; the step and the optimizer's count; every gradient."""
    got, want = runs["synced"][step]["metrics"], runs["jmetrics"][step]
    assert set(got) == set(want)
    assert {"loss/seg", "loss/proposals_probs", "loss/refined_rot",
            "loss/rescore", "loss/total", "lr"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    jst = runs["jstates"][step + 1]
    assert runs["synced"][step]["step"] == int(jst.step) == step + 1
    assert runs["synced"][step]["count"] == int(jst.opt_state[0].count)
    g, w = runs["synced"][step]["grads"], runs["jgrads"][step]
    assert set(g) == set(w)
    tol = {k: BN_SHIFT_REL if k.startswith("backbone.") and k.endswith(".bn.bias")
           else GRAD_REL for k in w}
    bad = {k: _rel(g[k], w[k]) for k in w if not _rel(g[k], w[k]) <= tol[k]}
    assert not bad, bad


def test_predict_step(runs):
    got, want = runs["tpred"], runs["jpred"]
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    for f in ("pos", "dims", "rot", "probs"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f),
                                   atol=BOX_ATOL, rtol=BOX_ATOL, err_msg=f)
