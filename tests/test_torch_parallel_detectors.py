"""Sharded train steps of TransFusion, PointPillars and PointRCNN
(DetectorTrainer(network="transfusion", group=), PointPillarsTrainer(group=),
PointRCNNTrainer(group=)) over two gloo ranks, against the port's
one-process step on the full batch and against the JAX step sharded on
make_mesh(2) (the 8-device CPU mesh of tests/conftest.py; its Hungarian
stage is one pure_callback, which GSPMD runs on the gathered batch).

Both sides start from the same random flax state (carried across by
liso_tpu_torch.weights), on the same numpy batch of 2 samples, one a rank.
The shards are unbalanced (test_shards_are_unbalanced): sample 0 holds two
objects and their boxes (PointRCNN: three), sample 1 background only with
30% of its points invalid and no box (PointRCNN: one), so the heatmap's
and the Hungarian terms' counts, the foreground and re-scored counts and
the BatchNorm statistics all differ between the ranks.

Tolerances, fp32, and why (tests/test_torch_parallel.py's for CenterPoint,
tests/test_torch_{transfusion,pointpillars,pointrcnn}.py's against JAX):
- Against the one-process step the only change is the order of sums
  (batch-1 against batch-2 convolutions, flax's two-pass BatchNorm over two
  partial sums against F.batch_norm): loss terms LOSS_RTOL_ONE 5e-5, grad
  norm 1e-3, BN running statistics STATS_RTOL 1e-6.
- Against JAX: loss terms 1e-4, BN running statistics 1e-6.
- Gradients per tensor, against either: GRAD_REL 3e-2 of the tensor's norm
  (the detector gradient is ill-conditioned: the port against itself at 1
  and 4 CPU threads differs by 1.7e-2), except the BatchNorm shifts of
  PointPillars' and PointRCNN's backbones, 7e-2 (the PointRCNN limit of
  tests/test_torch_pointrcnn.py: sums of cotangents that the next
  BatchNorm made mean-free; measured 3.5e-2 on a PointPillars FPN shift
  against the one-process step), and
  TransFusion's attention key biases, whose gradient is 0 in exact
  arithmetic and is held to 1e-6 of the weight's gradient.

Data rules (those of tests/test_torch_{transfusion,pointpillars,
pointrcnn}.py): no valid GT row is matched to prediction 0 (where the
reference's padded rows would clear the match,
liso_tpu/losses/hungarian_loss.py:67-70); no valid GT's best anchor is
anchor 0 (the reference's force-match fault,
liso_tpu/models/pointpillars.py:157-158); and every GT's best anchor leads
its second by more than 1e-3 (test_data_keeps_the_parity_rules).
"""
import copy
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.models.box_decode import BoxPredictionCfg as JCfg
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu.ops.boxes import Boxes as JBoxes
from liso_tpu.parallel.mesh import make_mesh as j_make_mesh
from liso_tpu.parallel.mesh import shard_batch as j_shard_batch
from liso_tpu.train.detector_train import DetectorTrainer as JDetTrainer
from liso_tpu.train.detector_train import DetectorTrainState
from liso_tpu.train.pointpillars_train import PointPillarsTrainer as JPPTrainer
from liso_tpu.train.pointpillars_train import PPTrainState
from liso_tpu.train.pointrcnn_train import PointRCNNTrainer as JPRTrainer
from liso_tpu.train.pointrcnn_train import PRTrainState
from liso_tpu_torch.losses import hungarian_loss
from liso_tpu_torch.models.pointpillars import anchor_gt_iou
from liso_tpu_torch.parallel.mesh import RankProcesses
from liso_tpu_torch.weights import flax_state_dict, load_detector_train_state
from test_torch_modules import random_variables
from test_torch_parallel_ranks import (
    OTHER_CFG,
    OTHER_NETWORKS,
    TF_BOX,
    TF_LAYERS,
    WORLD,
    det_batch,
    other_data,
    other_trainer,
    run_det_step,
    run_other_cases,
)

torch.set_num_threads(1)
SEEDS = {"transfusion": 41, "pointpillars": 51, "pointrcnn": 61}
LOSS_RTOL_ONE = 5e-5
JAX_LOSS_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-3
STATS_RTOL = 1e-6
GRAD_REL = 3e-2
BN_SHIFT_REL = 7e-2
ZERO_GRAD = ("attn.key.bias", "model.key_pos_mlp.bias")
ZERO_GRAD_REL = 1e-6
BEST_GAP = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _rel(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp(min=1e-30))


def _jax_trainer(net):
    bev = JBev((40.0, 40.0), (64, 64))
    if net == "transfusion":
        return JDetTrainer(bev, network="transfusion", box_cfg=JCfg(**TF_BOX),
                           num_decoder_layers=TF_LAYERS, pre_max_boxes=200,
                           **OTHER_CFG), DetectorTrainState
    if net == "pointpillars":
        return JPPTrainer(bev, **OTHER_CFG), PPTrainState
    return JPRTrainer(bev, **OTHER_CFG), PRTrainState


def _jax_state(net, data):
    """A random JAX train state at step 0 (AdamW's moments at 0), the JAX
    trainer and the batch."""
    pts, valid, boxes = data
    jt, cls = _jax_trainer(net)
    jp, jv = jnp.asarray(pts), jnp.asarray(valid)
    jboxes = JBoxes(**{k: jnp.asarray(v) for k, v in boxes.items()})
    v = random_variables(jt.model.init, jp, jv, seed=SEEDS[net])
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = cls(step=jnp.zeros((), jnp.int32), params=params,
                batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                   v["batch_stats"]),
                opt_state=jt.tx.init(params))
    return jt, (jp, jv, jboxes), _np(state)


def _jax_sharded_step(jt, jbatch, state, jmesh, model):
    """JAX's train step with the batch sharded on the mesh: its metrics,
    its gradient (AdamW's first moment from 0 is 0.1 g) and its BN running
    statistics, in the port's names."""
    with jmesh:
        st, m = jt.train_step(jax.tree_util.tree_map(jnp.asarray, state),
                              *j_shard_batch(jmesh, jbatch))
    st = _np(st)
    mu = flax_state_dict(model, {"params": st.opt_state[0].mu})
    return {"metrics": {k: float(x) for k, x in m.items()},
            "grads": {k: v / 0.1 for k, v in mu.items()},
            "stats": flax_state_dict(model, {"batch_stats": st.batch_stats})}


def _one_process(net, state):
    """The port's step on the full batch, recording every Hungarian match
    it makes (the data rule on prediction 0)."""
    tr = other_trainer(net)
    tr.load_state_dict(state)
    matches = []
    orig = hungarian_loss.hungarian_match

    def recording(gt, pred):
        m = orig(gt, pred)
        matches.append((m.clone(), gt.valid.clone()))
        return m

    hungarian_loss.hungarian_match = recording
    try:
        res = run_det_step(tr, det_batch(other_data(net)))
    finally:
        hungarian_loss.hungarian_match = orig
    return res, matches


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_in, states = {}, {}
    for net in OTHER_NETWORKS:
        jt, jb, s0 = _jax_state(net, other_data(net))
        jax_in[net] = (jt, jb, s0)
        tr = other_trainer(net)
        load_detector_train_state(tr, {
            "step": s0.step, "params": s0.params,
            "batch_stats": s0.batch_stats, "mu": s0.opt_state[0].mu,
            "nu": s0.opt_state[0].nu, "count": s0.opt_state[0].count})
        states[net] = copy.deepcopy(tr.state_dict())
    ranks = RankProcesses(run_other_cases, WORLD, (states,), backend="gloo",
                          workdir=tmp_path_factory.mktemp("ranks"),
                          timeout_s=600)
    jmesh = j_make_mesh(2)
    try:
        with ThreadPoolExecutor(3) as pool:
            f_jax = {net: pool.submit(_jax_sharded_step, *jax_in[net], jmesh,
                                      other_trainer(net).model)
                     for net in OTHER_NETWORKS}
            one = {net: _one_process(net, states[net])
                   for net in OTHER_NETWORKS}
            jax_res = {net: f.result() for net, f in f_jax.items()}
            rank_res = ranks.join()
    finally:
        ranks.stop()
    return dict(ranks=rank_res, one={n: r for n, (r, _) in one.items()},
                matches={n: m for n, (_, m) in one.items()}, jax=jax_res)


def _grad_tol(net, k):
    if net != "transfusion" and k.endswith(".bn.bias"):
        return BN_SHIFT_REL
    return GRAD_REL


def _check_grads(net, got, want):
    assert set(got) == set(want)
    bad = {}
    for k in want:
        if k.endswith(ZERO_GRAD):
            wn = float(want[k[: -len("bias")] + "weight"].norm())
            for g in (got, want):
                if not float(g[k].norm()) <= ZERO_GRAD_REL * wn:
                    bad[k] = float(g[k].norm()) / wn
        elif not _rel(got[k], want[k]) <= _grad_tol(net, k):
            bad[k] = _rel(got[k], want[k])
    assert not bad, bad


# ---------------------------------------------------------------------------
def test_shards_are_unbalanced():
    for net in OTHER_NETWORKS:
        pts, valid, boxes = other_data(net)
        n_boxes = boxes["valid"].sum(-1).tolist()
        assert n_boxes == ([3, 1] if net == "pointrcnn" else [2, 0]), net
        assert valid[0].sum() > 1.2 * valid[1].sum()


def test_data_keeps_the_parity_rules(runs):
    """No valid GT row is matched to prediction 0 in any Hungarian stage of
    the step (TransFusion: every decoder layer; PointRCNN: both stages),
    and some are matched; every valid GT's best anchor is not anchor 0 and
    leads the second by more than BEST_GAP."""
    for net in ("transfusion", "pointrcnn"):
        ms = runs["matches"][net]
        assert len(ms) == (TF_LAYERS if net == "transfusion" else 2)
        for match, gt_valid in ms:
            assert not ((match == 0) & gt_valid).any(), net
            assert ((match > 0) & gt_valid).any(), net
    tr = other_trainer("pointpillars")
    pts, valid, boxes = det_batch(other_data("pointpillars"))
    with torch.no_grad():
        cls = tr.model(pts, valid)[0]
    iou = anchor_gt_iou(tr.anchors_flat(cls.shape[1:3]), boxes)
    best = iou.argmax(dim=1)
    assert not ((best == 0) & boxes.valid).any()
    top2 = iou.topk(2, dim=1).values
    assert float((top2[:, 0] - top2[:, 1])[boxes.valid].min()) > BEST_GAP


def test_ranks_end_bitwise_equal(runs):
    a, b = runs["ranks"]
    for net in OTHER_NETWORKS:
        for coll in ("params", "nu", "buffers", "grads"):
            for k, v in a[net][coll].items():
                assert torch.equal(v, b[net][coll][k]), (net, coll, k)
        assert a[net]["metrics"] == b[net]["metrics"]


@pytest.mark.parametrize("net", OTHER_NETWORKS)
def test_step_matches_one_process(runs, net):
    """Loss terms (and TransFusion's grad norm), the gradient, the BN
    running statistics and AdamW's second moment of the 2-rank step
    against the one-process step on the full batch."""
    got, want = runs["ranks"][0][net], runs["one"][net]
    assert set(got["metrics"]) == set(want["metrics"])
    assert "loss/total" in got["metrics"]
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(
            got["metrics"][k], w, atol=1e-7, err_msg=k,
            rtol=GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL_ONE)
    _check_grads(net, got["grads"], want["grads"])
    assert want["buffers"]
    for k, w in want["buffers"].items():
        assert _rel(got["buffers"][k], w) <= STATS_RTOL, k


@pytest.mark.parametrize("net", OTHER_NETWORKS)
def test_step_matches_jax_sharded(runs, net):
    """Every metric of JAX's sharded train step (loss terms, the total, the
    learning rate, TransFusion's grad norm), its gradient and its BN
    running statistics."""
    got, j = runs["ranks"][0][net], runs["jax"][net]
    assert set(got["metrics"]) == set(j["metrics"])
    for k, w in j["metrics"].items():
        np.testing.assert_allclose(
            got["metrics"][k], w, atol=1e-7, err_msg=k,
            rtol=GRAD_NORM_RTOL if k == "grad_norm" else JAX_LOSS_RTOL)
    _check_grads(net, got["grads"], j["grads"])
    for k, w in j["stats"].items():
        assert _rel(got["buffers"][k], w) <= STATS_RTOL, k


def test_hungarian_terms_are_matched(runs):
    """The Hungarian box terms are not 0: the sharded normalisers are
    exercised on matched rows."""
    m = runs["ranks"][0]
    assert m["transfusion"]["metrics"]["loss/hungarian_pos"] > 0
    assert m["transfusion"]["metrics"]["loss/hungarian_pos_aux0"] > 0
    assert m["pointrcnn"]["metrics"]["loss/proposals_pos"] > 0
    assert m["pointrcnn"]["metrics"]["loss/refined_pos"] > 0


def test_trainers_keep_batch_norms_local_without_a_group():
    for net in OTHER_NETWORKS:
        tr = other_trainer(net)
        assert tr.group is None
        assert all(getattr(m, "group", None) is None
                   for m in tr.model.modules())
