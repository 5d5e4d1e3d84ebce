"""The ported detector train and predict steps as a whole:
liso_tpu_torch.train.detector_train.DetectorTrainer against the JAX
DetectorTrainer (liso_tpu/train/detector_train.py:151-217), baseline
CenterPoint, fp32, cut to grid 64 over 40 m, batch 2, 1024 points per
frame, 8 target slots. Both sides start from the same random flax state
(carried across by liso_tpu_torch.weights.load_detector_train_state) and
take three steps on the same batch.

On the CPU the JAX step scatters with segment_max; the port runs its
kernels' plain versions (the TPU VJP of the scatter-max). In this step the
scatter's ties are ReLU zeros, whose derivative is 0 on both sides.

The JAX gradient at state k comes from the AdamW first moment:
mu_{k+1} = 0.9 mu_k + 0.1 g_k, so g_k = (mu_{k+1} - 0.9 mu_k) / 0.1,
without a second compile.

The port runs each step twice: from the JAX state of that step (the
per-step comparisons), and free running from state 0 (the metrics).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu.ops.boxes import Boxes as JBoxes
from liso_tpu.train.detector_train import DetectorTrainer as JTrainer
from liso_tpu.train.detector_train import DetectorTrainState
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.train.detector_train import DetectorTrainer
from liso_tpu_torch.weights import flax_state_dict, load_detector_train_state
from test_torch_modules import random_variables

torch.set_num_threads(1)
GRID, RANGE, B, N, K, STEPS = 64, 40.0, 2, 1024, 8, 3
# A cycle of 100 steps at max_lr 1e-5: the states of the three steps stay
# close to each other, so the free-running port follows the JAX states
# (AdamW's first steps move each element by about lr whatever its gradient)
CFG = dict(max_lr=1e-5, total_steps=100, pre_max_boxes=200, post_max_boxes=40)
# Tolerances, fp32 on both sides, and why:
# - the two sides sum convolutions, batch statistics and the loss in other
#   orders: the loss terms agree to 4e-5 on this data, the grad norm to
#   2.4e-4.
LOSS_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-3
# - The gradient of this random network is ill-conditioned: each BN
#   backward subtracts per-channel means from cotangents that are nearly
#   constant per channel (the focal loss's negatives dominate), so fp32
#   rounding is amplified. The port against ITSELF at 1 and 4 CPU threads
#   (another reduction order, same code) differs by up to 1.7e-2 of a
#   tensor's norm at state 0, and the port against JAX by as much.
GRAD_REL = 3e-2  # |g_port - g_jax| / |g_jax| per tensor
# - The one conv bias that feeds a BatchNorm has a gradient of exactly 0 in
#   exact arithmetic (the norm removes a per-channel constant); both sides
#   give rounding noise, 4e-8 of the conv weight's gradient norm. It is
#   held to that bound, not compared, and its AdamW moments and update
#   (noise scaled to a full step) are skipped.
NORMED_BIAS = "model.sep_head.fused_conv0.bias"
ZERO_GRAD_REL = 1e-6
# - AdamW normalises each element: its first step moves every element by
#   lr with the sign of its gradient, so an element whose gradient lies
#   within the noise above may step the other way (measured: 18% of the
#   update's norm on a 128-element BN scale at state 0; over all tensors
#   together 3.5e-2). The moments mu (linear in g) and nu (quadratic) keep
#   the gradient's relative error.
UPDATE_REL = 0.25
UPDATE_GLOBAL_REL = 5e-2
MU_REL, NU_REL = GRAD_REL, 2 * GRAD_REL
# - BN running statistics: 0.99 of the carried state plus 0.01 of the
#   batch's, so their difference is that of the batch statistics / 100
#   (measured 8e-8).
STATS_REL = 1e-6
# - predict_step: sigmoid probabilities and decoded boxes of the same
#   network, the same kept set and order (no score or IoU of this data lies
#   within fp32 noise of the thresholds).
BOX_ATOL = 1e-4


def _scene(seed):
    """A frame of background points and two dense box-shaped objects, with
    its two target boxes (8 slots, 6 empty)."""
    rng = np.random.RandomState(seed)
    centers = np.array([[5.0, 2.0, -1.0], [-8.0, -3.0, -1.0]]) + rng.uniform(-1, 1, (2, 3))
    bg = rng.uniform(-18, 18, (N - 512, 3))
    bg[:, 2] = rng.uniform(-1.8, 0.5, len(bg))
    objs = [rng.uniform(-1, 1, (256, 3)) * [2.0, 1.0, 0.7] + c for c in centers]
    pts = np.concatenate([bg, *objs])
    pts = np.concatenate([pts, rng.rand(N, 1)], -1).astype(np.float32)
    boxes = {
        "pos": np.zeros((K, 3)), "dims": np.zeros((K, 3)), "rot": np.zeros((K, 1)),
        "probs": np.zeros((K, 1)), "velo": np.zeros((K, 1)),
        "valid": np.zeros(K, bool),
    }
    boxes["pos"][:2] = centers
    boxes["dims"][:2] = [4.0, 2.0, 1.5]
    boxes["rot"][:2, 0] = rng.uniform(-0.3, 0.3, 2)
    boxes["probs"][:2] = 1.0
    boxes["valid"][:2] = True
    return pts, boxes


def _batch():
    scenes = [_scene(s) for s in range(B)]
    pts = np.stack([s[0] for s in scenes])
    valid = np.random.RandomState(9).rand(B, N) > 0.05
    boxes = {k: np.stack([s[1][k] for s in scenes]) for k in scenes[0][1]}
    boxes = {k: v if k == "valid" else v.astype(np.float32)
             for k, v in boxes.items()}
    boxes["class_id"] = np.full((B, K, 1), np.iinfo(np.int32).max, np.int32)
    boxes["difficulty"] = np.zeros((B, K, 1), np.int32)
    return pts, valid, boxes


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _flat(d):
    return {k: v.detach().clone() for k, v in d.items()}


def _as_port(s):
    return {"step": s.step, "params": s.params, "batch_stats": s.batch_stats,
            "mu": s.opt_state[0].mu, "nu": s.opt_state[0].nu,
            "count": s.opt_state[0].count}


@pytest.fixture(scope="module")
def runs():
    pts, valid, boxes = _batch()
    jt = JTrainer(JBev((RANGE, RANGE), (GRID, GRID)), **CFG)
    jp, jv = jnp.asarray(pts), jnp.asarray(valid)
    jboxes = JBoxes(**{k: jnp.asarray(v) for k, v in boxes.items()})
    v = random_variables(jt.model.init, jp, jv, seed=31)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state0 = DetectorTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
        opt_state=jt.tx.init(params),
    )

    def fresh(s):  # train_step donates its state
        return jax.tree_util.tree_map(jnp.asarray, s)

    jstates, jmetrics = [_np(state0)], []
    for _ in range(STEPS):
        st, m = jt.train_step(fresh(jstates[-1]), jp, jv, jboxes)
        jstates.append(_np(st))
        jmetrics.append({k: float(x) for k, x in m.items()})
    jpred = _np(jt.predict_step(fresh(jstates[-1]), jp, jv))

    tt = DetectorTrainer(BevSetup((RANGE, RANGE), (GRID, GRID)), device="cpu",
                         **CFG)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(valid)
    tboxes = Boxes(**{k: torch.from_numpy(v) for k, v in boxes.items()})
    synced = []
    for k in range(STEPS):
        load_detector_train_state(tt, _as_port(jstates[k]))
        p_before = _flat(tt.params)
        m = tt.train_step(tp, tv, tboxes)
        synced.append(dict(
            metrics={n: float(x) for n, x in m.items()},
            grads={n: p.grad.clone() for n, p in tt.params.items()},
            update={n: p.detach() - p_before[n] for n, p in tt.params.items()},
            mu=_flat(tt.mu), nu=_flat(tt.nu), step=tt.step, count=tt.count,
            state=_flat(tt.model.state_dict()),
        ))
    load_detector_train_state(tt, _as_port(jstates[-1]))
    tpred = tt.predict_step(tp, tv)
    load_detector_train_state(tt, _as_port(jstates[0]))
    free = [{n: float(x) for n, x in tt.train_step(tp, tv, tboxes).items()}
            for _ in range(STEPS)]

    model = tt.model

    def moment(s, name):
        return flax_state_dict(model, {"params": getattr(s.opt_state[0], name)})

    jgrads = [{k: (moment(b, "mu")[k] - 0.9 * moment(a, "mu")[k]) / 0.1
               for k in moment(a, "mu")}
              for a, b in zip(jstates[:-1], jstates[1:])]
    return dict(jstates=jstates, jmetrics=jmetrics, jgrads=jgrads, jpred=jpred,
                tpred=tpred, model=model, synced=synced, free=free,
                moment=moment)


def _rel(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp(min=1e-30))


def _jax(runs, k, coll):
    st = runs["jstates"][k]
    if coll in ("mu", "nu"):
        return runs["moment"](st, coll)
    return flax_state_dict(runs["model"], {coll: getattr(st, coll)})


def test_metrics_every_step(runs):
    """Loss terms, learning rate and grad norm of each step, from the same
    JAX state and free running from state 0."""
    for step in range(STEPS):
        want = runs["jmetrics"][step]
        for got in (runs["synced"][step]["metrics"], runs["free"][step]):
            assert set(got) == set(want), step
            for k in want:
                rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
                np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                           err_msg=f"step {step} {k}")
    assert runs["jmetrics"][0]["loss/total"] > 0
    assert runs["free"][0]["lr"] == pytest.approx(1e-6, rel=1e-5)


@pytest.mark.parametrize("step", range(STEPS))
def test_gradients_per_tensor(runs, step):
    """Every parameter's gradient at each state, by relative norm."""
    got, want = runs["synced"][step]["grads"], runs["jgrads"][step]
    bad = {k: _rel(got[k], want[k]) for k in want
           if k != NORMED_BIAS and not _rel(got[k], want[k]) <= GRAD_REL}
    assert not bad, bad
    w = NORMED_BIAS[: -len("bias")] + "weight"
    for g in (got, want):
        assert float(g[NORMED_BIAS].norm()) <= ZERO_GRAD_REL * float(g[w].norm())
    assert len(want) == len(got) == sum(1 for _ in runs["model"].parameters())


@pytest.mark.parametrize("step", range(STEPS))
def test_state_after_each_step(runs, step):
    """From JAX state k, one port step gives JAX state k + 1: parameter
    update, AdamW moments, BN running statistics, step and count."""
    got = runs["synced"][step]
    p0, p1 = _jax(runs, step, "params"), _jax(runs, step + 1, "params")
    bad = {}
    keys = [k for k in got["update"] if k != NORMED_BIAS]
    for k in keys:
        if not _rel(got["update"][k], p1[k] - p0[k]) <= UPDATE_REL:
            bad[k] = ("update", _rel(got["update"][k], p1[k] - p0[k]))
    cat = lambda ts: torch.cat([t.reshape(-1) for t in ts])
    glob = _rel(cat(got["update"][k] for k in keys), cat(p1[k] - p0[k] for k in keys))
    if not glob <= UPDATE_GLOBAL_REL:
        bad["all tensors"] = ("update", glob)
    for name, tol in (("mu", MU_REL), ("nu", NU_REL)):
        want = _jax(runs, step + 1, name)
        for k in keys:
            if not _rel(got[name][k], want[k]) <= tol:
                bad[k] = (name, _rel(got[name][k], want[k]))
    for k, want in _jax(runs, step + 1, "batch_stats").items():
        if not _rel(got["state"][k], want) <= STATS_REL:
            bad[k] = ("stats", _rel(got["state"][k], want))
    assert not bad, bad
    jst = runs["jstates"][step + 1]
    assert got["step"] == int(jst.step) == step + 1
    assert got["count"] == int(jst.opt_state[0].count) == int(jst.opt_state[2].count)


def test_predict_step(runs):
    """predict_step from JAX state 3: the same valid slots, and the boxes
    within BOX_ATOL."""
    got, want = runs["tpred"], runs["jpred"]
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    assert int(got.valid.sum()) > 0
    for f in ("pos", "dims", "rot", "probs"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f),
                                   atol=BOX_ATOL, rtol=BOX_ATOL, err_msg=f)


@pytest.fixture(scope="module")
def non_baseline():
    """The non-baseline CenterPoint (use_baseline_parameters=False: the
    two-stage RPN, a stride-2 shared conv, predictions at /8): one JAX step
    from a random state and predict_step after it; the port from the same
    states."""
    pts, valid, boxes = _batch()
    jt = JTrainer(JBev((RANGE, RANGE), (GRID, GRID)),
                  use_baseline_parameters=False, **CFG)
    jp, jv = jnp.asarray(pts), jnp.asarray(valid)
    jboxes = JBoxes(**{k: jnp.asarray(v) for k, v in boxes.items()})
    v = random_variables(jt.model.init, jp, jv, seed=32)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state0 = DetectorTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
        opt_state=jt.tx.init(params),
    )
    st, m = jt.train_step(jax.tree_util.tree_map(jnp.asarray, _np(state0)),
                          jp, jv, jboxes)
    state1 = _np(st)
    jpred = _np(jt.predict_step(jax.tree_util.tree_map(jnp.asarray, state1),
                                jp, jv))
    tt = DetectorTrainer(BevSetup((RANGE, RANGE), (GRID, GRID)),
                         use_baseline_parameters=False, device="cpu", **CFG)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(valid)
    load_detector_train_state(tt, _as_port(_np(state0)))
    tm = tt.train_step(tp, tv, Boxes(**{k: torch.from_numpy(x)
                                        for k, x in boxes.items()}))
    grads = {n: p.grad.clone() for n, p in tt.params.items()}
    load_detector_train_state(tt, _as_port(state1))
    jgrad = {k: x / 0.1 for k, x in flax_state_dict(
        tt.model, {"params": state1.opt_state[0].mu}).items()}
    return dict(jmetrics={k: float(x) for k, x in m.items()},
                metrics={k: float(x) for k, x in tm.items()}, grads=grads,
                jgrads=jgrad, jpred=jpred, tpred=tt.predict_step(tp, tv))


def test_non_baseline_train_step(non_baseline):
    """Loss terms, learning rate and grad norm within the baseline's
    tolerances, and every gradient (the normed bias held to its bound)."""
    got, want = non_baseline["metrics"], non_baseline["jmetrics"]
    assert set(got) == set(want)
    for k in want:
        rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    g, w = non_baseline["grads"], non_baseline["jgrads"]
    bad = {k: _rel(g[k], w[k]) for k in w
           if k != NORMED_BIAS and not _rel(g[k], w[k]) <= GRAD_REL}
    assert not bad, bad
    wk = NORMED_BIAS[: -len("bias")] + "weight"
    assert float(g[NORMED_BIAS].norm()) <= ZERO_GRAD_REL * float(g[wk].norm())


def test_non_baseline_predict_step(non_baseline):
    """predict_step after the step: the same kept set, boxes within
    BOX_ATOL."""
    got, want = non_baseline["tpred"], non_baseline["jpred"]
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    assert int(got.valid.sum()) > 0
    for f in ("pos", "dims", "rot", "probs"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f),
                                   atol=BOX_ATOL, rtol=BOX_ATOL, err_msg=f)
