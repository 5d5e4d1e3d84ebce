"""TransFusion in the port against the JAX package, fp32, grid 64 over
40 m, batch 2, 1024 points per frame, 8 target slots: the Hungarian set
loss (liso_tpu/losses/hungarian_loss.py), local-max suppression,
TransFusionNet at 1 and 2 decoder layers (liso_tpu/models/transfusion.py)
and DetectorTrainer's transfusion train and predict steps
(liso_tpu/train/detector_train.py:97-137), with random flax weights carried
across by liso_tpu_torch.weights.

Tolerances: forward maps 1e-4; the same selected query indices; loss terms
1e-4; gradients 3e-2 of each tensor's norm (as the detector step:
tests/test_torch_detector_train.py); predicted boxes 1e-4 with the same
kept set.

The reference's probs target has a duplicate-index scatter: every
unmatched GT row, padded rows included, writes False to prediction 0
(liso_tpu/losses/hungarian_loss.py:67-70). The port marks exactly the
predictions a valid GT row is assigned to. `test_reference_fault_*` show
both sides; the parity tests use data where the fault does not fire, and
each asserts that of its data: JAX gives the same loss without the padded
rows.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.losses.hungarian_loss import hungarian_matching_loss as j_hung
from liso_tpu.models import transfusion as jtf
from liso_tpu.models.box_decode import BoxPredictionCfg as JCfg
from liso_tpu.models.box_learner import BoxLearner as JBoxLearner
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu.ops.boxes import Boxes as JBoxes
from liso_tpu.train.detector_train import DetectorTrainer as JTrainer
from liso_tpu.train.detector_train import DetectorTrainState
from liso_tpu_torch.losses.hungarian_loss import hungarian_matching_loss
from liso_tpu_torch.models import transfusion as ttf
from liso_tpu_torch.models.box_decode import BoxPredictionCfg
from liso_tpu_torch.models.box_learner import BoxLearner
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.train.detector_train import DetectorTrainer
from liso_tpu_torch.weights import (
    flax_state_dict,
    load_detector_train_state,
    load_flax_variables,
)
from test_torch_detector_modules import both, random_boxes
from test_torch_detector_train import _as_port, _batch, _np, _rel
from test_torch_modules import random_variables

torch.set_num_threads(1)
GRID, RANGE = 64, 40.0
MAP_ATOL = LOSS_RTOL = BOX_ATOL = 1e-4
GRAD_REL = 3e-2
# Biases whose gradient is 0 in exact arithmetic: an attention's key bias
# (and the key position MLP's bias, which reaches the keys only through
# the key projection) shifts every key's logit for a query by one
# constant, which the softmax removes. Both sides give rounding noise
# (measured 1e-9); it is held to ZERO_GRAD_REL of the weight's gradient.
ZERO_GRAD = ("attn.key.bias", "model.key_pos_mlp.bias")
ZERO_GRAD_REL = 1e-6
# the transfusion preset's box prediction (liso_config.yml:549-566 with
# predict_rot_as_vector)
TF_BOX = dict(position_method="global_absolute",
              dimensions_method="predict_abs_size", rotation_method="vector",
              activations={"pos": "none", "rot": "none", "dims": "none",
                           "probs": "none"})
CFG = dict(max_lr=1e-5, total_steps=100, pre_max_boxes=200, post_max_boxes=40)


def _pred_boxes(rng, b, p, gt):
    """Predictions scattered around the valid GT centers (so that some fall
    within the 2 m matching radius) and far ones, random logits."""
    pos = rng.uniform(-15, 15, (b, p, 3)).astype(np.float32)
    for i in range(b):
        centers = gt["pos"][i][gt["valid"][i]]
        for j in range(min(len(centers) * 2, p)):
            pos[i, p - 1 - j] = centers[j % len(centers)] + rng.uniform(-1.2, 1.2, 3)
    d = random_boxes(rng, b, p, valid_frac=0.9)
    d["pos"] = pos.astype(np.float32)
    d["probs"] = rng.randn(b, p, 1).astype(np.float32)
    return d


def _hung_pair(seed, g=6, p=12):
    rng = np.random.RandomState(seed)
    gt = random_boxes(rng, 2, g, valid_frac=1.0, spread=12.0)
    gt["valid"][:, 3:] = False  # 3 valid rows, then padding
    return gt, _pred_boxes(rng, 2, p, gt)


def _truncate(d, g):
    return {k: v[:, :g] for k, v in d.items()}


# the JAX loss's host callback runs under jit, as in the JAX train step
# (called eagerly, its callback thread and the dispatching thread can
# deadlock)
j_hung_jit = jax.jit(j_hung)


def _jax_loss(gt, pred):
    jg, _ = both(gt)
    jp, _ = both(pred)
    return {k: float(v) for k, v in j_hung_jit(jg, jp).items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hungarian_loss(seed):
    gt, pred = _hung_pair(seed)
    want = _jax_loss(gt, pred)
    # the reference's fault does not fire on this data
    unpadded = _jax_loss(_truncate(gt, 3), pred)
    assert unpadded == pytest.approx(want, rel=1e-6)
    _, tg = both(gt)
    _, tp = both(pred)
    tp.probs.requires_grad_(True)
    got = hungarian_matching_loss(tg, tp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), want[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    assert want["probs"] > 0 and want["pos"] > 0  # some queries matched
    got["probs"].backward()
    assert bool(torch.isfinite(tp.probs.grad).all())


def _fault_case(n_pad):
    """One GT box at (0, 0), then n_pad padded rows; predictions at
    (0.1, 0), (10, 10) and (20, 20), every logit 5."""
    g = 1 + n_pad
    gt = {"pos": np.zeros((1, g, 3), np.float32),
          "dims": np.ones((1, g, 3), np.float32),
          "rot": np.zeros((1, g, 1), np.float32),
          "probs": np.ones((1, g, 1), np.float32),
          "valid": np.arange(g)[None] < 1}
    pred = {"pos": np.array([[[0.1, 0, 0], [10, 10, 0], [20, 20, 0]]], np.float32),
            "dims": np.ones((1, 3, 3), np.float32),
            "rot": np.zeros((1, 3, 1), np.float32),
            "probs": np.full((1, 3, 1), 5.0, np.float32),
            "valid": np.ones((1, 3), bool)}
    return gt, pred


def _focal_oracle(logits, positive):
    """numpy focal_heatmap_loss (alpha 0.5, gamma 2, no ignore, no
    gaussian): the intended probs target."""
    x = logits.astype(np.float64)
    sig = 1 / (1 + np.exp(-x))
    logsig = -np.log1p(np.exp(-x))
    logsig_neg = -np.log1p(np.exp(x))
    pos = 0.5 * (1 - sig) ** 2 * logsig
    neg = 0.5 * sig ** 2 * logsig_neg
    return -(pos[positive].sum() + neg[~positive].sum()) / max(positive.sum(), 1)


def test_reference_fault_padded_rows_clear_a_match():
    """JAX's probs term changes when padded GT rows are appended (they
    clear query 0's match); the port's does not, and equals the oracle."""
    j = {n: _jax_loss(*_fault_case(n)) for n in (0, 2)}
    assert j[0]["probs"] == pytest.approx(4.9399, abs=1e-4)
    assert j[2]["probs"] == pytest.approx(7.4099, abs=1e-4)
    assert j[0]["pos"] == j[2]["pos"] == pytest.approx(0.0333, abs=1e-4)
    for n in (0, 2):
        gt, pred = _fault_case(n)
        got = hungarian_matching_loss(both(gt)[1], both(pred)[1])
        assert float(got["probs"]) == pytest.approx(j[0]["probs"], rel=1e-6)
        assert float(got["pos"]) == pytest.approx(j[0]["pos"], rel=1e-6)


@pytest.mark.parametrize("seed", [3, 4])
def test_hungarian_probs_matches_oracle(seed):
    """The port's probs term against a numpy oracle of the intended
    target (positive iff a valid GT row is assigned), padded GT rows
    included; the assignment itself is scipy's, checked on the host."""
    from scipy.optimize import linear_sum_assignment

    gt, pred = _hung_pair(seed)
    pred["valid"][:] = True
    got = hungarian_matching_loss(both(gt)[1], both(pred)[1])
    positive = np.zeros(pred["valid"].shape, bool)
    for i in range(2):
        v = gt["valid"][i]
        cost = np.linalg.norm(gt["pos"][i][v][:, None, :2]
                              - pred["pos"][i][None, :, :2], axis=-1)
        for r, c in zip(*linear_sum_assignment(cost)):
            positive[i, c] |= cost[r, c] < 2.0
    want = _focal_oracle(pred["probs"][..., 0], positive)
    assert positive.sum() > 0
    np.testing.assert_allclose(float(got["probs"]), want, rtol=1e-5)


def test_local_max_suppress():
    rng = np.random.RandomState(5)
    heat = rng.rand(2, 12, 10, 2).astype(np.float32)
    heat[0, 3, 3:5, 0] = 0.999  # a tie of neighbours: both stay peaks
    for k in (1, 3, 5):
        want = np.asarray(jtf.local_max_suppress(jnp.asarray(heat), k))
        got = ttf.local_max_suppress(torch.from_numpy(heat), k).numpy()
        np.testing.assert_array_equal(got, want)


def _cloud(seed, n=1024, b=2):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-19, 19, (b, n, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 1, (b, n))
    return pts, rng.rand(b, n) > 0.05


def _query_idx_jax(dense_heatmap, k):
    heat = jtf.local_max_suppress(jax.nn.sigmoid(dense_heatmap), 3)
    b = heat.shape[0]
    flat = heat.transpose(0, 3, 1, 2).reshape(b, -1)
    return np.asarray(jax.lax.top_k(flat, k)[1])


def _query_idx_port(dense_heatmap, k):
    heat = ttf.local_max_suppress(torch.sigmoid(dense_heatmap), 3)
    flat = heat.permute(0, 3, 1, 2).reshape(heat.shape[0], -1)
    return torch.sort(flat, dim=-1, descending=True, stable=True).indices[:, :k].numpy()


@pytest.mark.parametrize("layers", [1, 2])
def test_transfusion_net(layers):
    """BoxLearner(network="transfusion") in eval mode: the dense heatmap,
    the selected queries, every layer's raw maps and the decoded boxes."""
    pts, valid = _cloud(20 + layers)
    jb, tb = JBev((RANGE, RANGE), (GRID, GRID)), BevSetup((RANGE, RANGE), (GRID, GRID))
    jm = JBoxLearner(jb, box_cfg=JCfg(**TF_BOX), network="transfusion",
                     num_decoder_layers=layers)
    v = random_variables(jm.init, jnp.asarray(pts), jnp.asarray(valid), seed=30 + layers)
    want_flat, _, _, want_aux = jax.jit(jm.apply)(v, jnp.asarray(pts), jnp.asarray(valid))
    tm = load_flax_variables(BoxLearner(tb, box_cfg=BoxPredictionCfg(**TF_BOX),
                                        network="transfusion",
                                        num_decoder_layers=layers), v)
    tm.eval()
    with torch.no_grad():
        got_flat, _, _, got_aux = tm(torch.from_numpy(pts), torch.from_numpy(valid))
    np.testing.assert_allclose(got_aux["heatmap"].numpy(), want_aux["heatmap"],
                               atol=MAP_ATOL, rtol=MAP_ATOL)
    k = tm.model.num_proposals
    np.testing.assert_array_equal(_query_idx_port(got_aux["heatmap"], k),
                                  _query_idx_jax(want_aux["heatmap"], k))
    np.testing.assert_allclose(got_aux["query_heatmap_score"].numpy(),
                               want_aux["query_heatmap_score"], atol=1e-6)
    assert len(got_aux["layer_maps"]) == len(want_aux["layer_maps"]) == layers
    for g, w in zip(got_aux["layer_maps"], want_aux["layer_maps"]):
        assert set(g) == set(w)
        for a in w:
            np.testing.assert_allclose(g[a].numpy(), w[a], atol=MAP_ATOL,
                                       rtol=MAP_ATOL, err_msg=a)
    for f in ("pos", "dims", "rot", "probs"):
        np.testing.assert_allclose(getattr(got_flat, f).numpy(),
                                   getattr(want_flat, f), atol=MAP_ATOL,
                                   rtol=MAP_ATOL, err_msg=f)


def test_transfusion_refuses_centerpoint_inputs():
    """A shared pillar image or the pre-scatter point features are
    CenterPoint's alone, as in JAX's BoxLearner."""
    pts, valid = _cloud(6, n=64, b=1)
    tm = BoxLearner(BevSetup((RANGE, RANGE), (GRID, GRID)), network="transfusion")
    with pytest.raises(NotImplementedError, match="centerpoint"):
        tm.point_feats(torch.from_numpy(pts), torch.from_numpy(valid))
    img = (torch.zeros(1, GRID, GRID, 64), torch.zeros(1, GRID, GRID, 1))
    with pytest.raises(NotImplementedError, match="centerpoint"):
        tm(torch.from_numpy(pts), torch.from_numpy(valid), pillar_image=img)


def test_weight_bridge_takes_every_transfusion_leaf():
    """A flax TransFusion's variables through the bridge: every leaf on
    both sides is used (the attention's rank-3 kernels, rank-2 biases and
    LayerNorms included), and a stray or missing leaf raises."""
    pts, valid = _cloud(3, n=256, b=1)
    bev = ((RANGE, RANGE), (GRID, GRID))
    jm = JBoxLearner(JBev(*bev), network="transfusion", num_decoder_layers=2)
    v = random_variables(jm.init, jnp.asarray(pts), jnp.asarray(valid), seed=4)
    tm = BoxLearner(BevSetup(*bev), network="transfusion", num_decoder_layers=2)
    tensors = flax_state_dict(tm, v)
    assert set(tensors) == set(tm.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(v))
    assert len(tensors) == n_leaves
    q = v["params"]["model"]["decoder1"]["cross_attn"]["query"]["kernel"]
    w = tensors["model.decoder1.cross_attn.query.weight"].numpy()
    np.testing.assert_array_equal(w[5 * 16 + 3], q[:, 5, 3])  # head 5, dim 3
    o = v["params"]["model"]["decoder0"]["self_attn"]["out"]["kernel"]
    w = tensors["model.decoder0.self_attn.out.weight"].numpy()
    np.testing.assert_array_equal(w[:, 2 * 16 + 7], o[2, 7])
    missing = jax.tree_util.tree_map(lambda x: x, v)
    del missing["params"]["model"]["decoder1"]["norm2"]
    with pytest.raises(KeyError, match="decoder1.norm2"):
        load_flax_variables(tm, missing)


def _jax_hungarian_by_layer(jt, forward, state, gts):
    """JAX's Hungarian terms of every decoder layer of the train-mode
    forward at `state`, against each GT set of `gts` (the fault check)."""
    from liso_tpu.models.box_decode import (
        apply_activations,
        decode_box_maps,
        flatten_to_boxes,
    )

    (_, _, _, aux), _ = forward({"params": state.params,
                                 "batch_stats": state.batch_stats})
    out = []
    for gt in gts:
        terms = {}
        for li, lm in enumerate(aux["layer_maps"]):
            flat = flatten_to_boxes(decode_box_maps(
                apply_activations(lm, jt.box_cfg), jt.box_cfg, jt.bev))
            terms.update({f"{k}{li}": float(x)
                          for k, x in j_hung_jit(gt, flat).items()})
        out.append(terms)
    return out


@pytest.fixture(scope="module")
def runs():
    """Two JAX train steps (2 decoder layers) from a random state and
    predict_step from the last; the port from each JAX state."""
    pts, valid, boxes = _batch()
    jb = JBev((RANGE, RANGE), (GRID, GRID))
    jt = JTrainer(jb, network="transfusion", box_cfg=JCfg(**TF_BOX),
                  num_decoder_layers=2, **CFG)
    jp, jv = jnp.asarray(pts), jnp.asarray(valid)
    jboxes = JBoxes(**{k: jnp.asarray(v) for k, v in boxes.items()})
    v = random_variables(jt.model.init, jp, jv, seed=41)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state0 = DetectorTrainState(
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
    assert (boxes["valid"][:, :n_valid]).all()
    unpadded = JBoxes(**{k: jnp.asarray(x[:, :n_valid]) for k, x in boxes.items()})
    forward = jax.jit(lambda v: jt.model.apply(v, jp, jv, train=True,
                                               mutable=["batch_stats"]))
    fault_free = [_jax_hungarian_by_layer(jt, forward, fresh(s),
                                          (jboxes, unpadded))
                  for s in jstates[:2]]

    tt = DetectorTrainer(BevSetup((RANGE, RANGE), (GRID, GRID)),
                         network="transfusion",
                         box_cfg=BoxPredictionCfg(**TF_BOX),
                         num_decoder_layers=2, device="cpu", **CFG)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(valid)
    tboxes = Boxes(**{k: torch.from_numpy(x) for k, x in boxes.items()})
    synced = []
    for k in range(2):
        load_detector_train_state(tt, _as_port(jstates[k]))
        m = tt.train_step(tp, tv, tboxes)
        synced.append(dict(
            metrics={n: float(x) for n, x in m.items()},
            grads={n: p.grad.clone() for n, p in tt.params.items()}))
    load_detector_train_state(tt, _as_port(jstates[-1]))
    tpred = tt.predict_step(tp, tv)

    def moment(s):
        return flax_state_dict(tt.model, {"params": s.opt_state[0].mu})

    jgrads = [{k: (moment(b)[k] - 0.9 * moment(a)[k]) / 0.1 for k in moment(a)}
              for a, b in zip(jstates[:-1], jstates[1:])]
    return dict(jmetrics=jmetrics, jgrads=jgrads, jpred=jpred, tpred=tpred,
                synced=synced, fault_free=fault_free)


def test_step_data_does_not_fire_the_reference_fault(runs):
    for padded, unpadded in runs["fault_free"]:
        assert padded == pytest.approx(unpadded, rel=1e-6)
        assert padded["pos0"] > 0 and padded["pos1"] > 0  # queries matched


@pytest.mark.parametrize("step", range(2))
def test_train_step_losses(runs, step):
    """Every loss term (heatmap, each layer's Hungarian terms), the learning
    rate and the grad norm, from the same JAX state."""
    got, want = runs["synced"][step]["metrics"], runs["jmetrics"][step]
    assert set(got) == set(want)
    assert {"loss/heatmap", "loss/hungarian_probs",
            "loss/hungarian_rot_aux0"} <= set(got)
    for k in want:
        rtol = 1e-3 if k == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("step", range(2))
def test_train_step_gradients(runs, step):
    got, want = runs["synced"][step]["grads"], runs["jgrads"][step]
    assert set(got) == set(want)
    zero = [k for k in want if k.endswith(ZERO_GRAD)]
    assert len(zero) == 5
    bad = {k: _rel(got[k], want[k]) for k in want
           if k not in zero and not _rel(got[k], want[k]) <= GRAD_REL}
    assert not bad, bad
    for k in zero:
        w = k[: -len("bias")] + "weight"
        for g in (got, want):
            assert float(g[k].norm()) <= ZERO_GRAD_REL * float(g[w].norm()), k
    # the heatmap that picks the queries carries no gradient: the
    # heatmap head learns from the focal loss alone, and the selected
    # queries reach the backbone through their gathered features
    assert float(got["model.heatmap_head.weight"].norm()) > 0


def test_predict_step(runs):
    got, want = runs["tpred"], runs["jpred"]
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    assert int(got.valid.sum()) > 0
    for f in ("pos", "dims", "rot", "probs"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f),
                                   atol=BOX_ATOL, rtol=BOX_ATOL, err_msg=f)
