"""Data parallel: liso_tpu_torch.parallel (the process group, shard_batch,
replicate, the cross-rank sums, dryrun_multichip) and the sharded SLIM and
CenterPoint train steps, against the port's one-process step on the full
batch and the JAX step sharded on make_mesh(2) (the 8-device CPU mesh of
tests/conftest.py).

Two gloo ranks are spawned once (tests/test_torch_parallel_ranks.py) and run
every case; meanwhile this process computes the references and runs
dryrun_multichip(2, device="cpu") in a thread. Both sides start from the
same random flax state (carried across by liso_tpu_torch.weights), on
the same numpy batch of 2 samples, one a rank. The shards are unbalanced
(test_shards_are_unbalanced), and a rank-local normalisation misses the
limits on them (test_*_local_normalisation_misses).

Tolerances, fp32, and why:
- Against the one-process step the only change is the order of sums: the
  2-rank step convolves batch 1 where the one-process step convolves batch
  2 (oneDNN sums the two differently: the SLIM encoder's features differ by
  1.6e-6 relative), its batch norms take flax's two passes over two partial
  sums where the one-process step runs F.batch_norm, and the histogram
  adds two. Measured on this data: CenterPoint loss terms 1.7e-5 apart
  (DET_LOSS_RTOL 5e-5), grad norms 6.0e-5 (GRAD_NORM_RTOL 1e-3, the card's
  detector limit), BN running statistics 5.8e-8 (STATS_RTOL 1e-6); SLIM
  loss terms 2.5e-7. In SLIM the corr values are rounded to bf16, so a
  last-bit change can flip a tap to its neighbouring bf16 value
  (test_torch_slim_train): on other data of the same shapes the loss terms
  moved by 2.7e-5 and the gradients by 9e-3 of a tensor's norm
  (SLIM_LOSS_RTOL 1e-4).
- Gradients per tensor: GRAD_REL 3e-2 against either reference, the limit
  of the single-process parity tests. The CenterPoint gradient is
  ill-conditioned (each BatchNorm backward cancels nearly constant
  cotangents): the port against itself at 1 and 4 CPU threads already
  differs by 1.7e-2 of a tensor's norm (test_torch_detector_train); the
  port's BatchNorm computes in fp32, so this comparison cannot run in
  float64 as test_dp_equivalence.py runs JAX's. The biases that feed a
  norm have a gradient of 0 in exact arithmetic and are held to a bound.
- RMSprop's first step from nu = 0 moves each element by about
  lr sqrt(10) whatever its gradient's size, so an element near 0 may step
  either way: the update is compared over all parameters at once
  (UPDATE_GLOBAL_REL 0.1; measured 0.055 against JAX), and nu = 0.1 g^2
  per tensor (NU_REL = 2 GRAD_REL), which holds the gradient's scale.
- Against JAX: the loss terms at the parity tests' limits (SLIM
  LOSS_RTOL 3e-4, test_torch_slim_train; CenterPoint 1e-4,
  test_torch_detector_train), the threshold histogram by its cumulative
  sum (CUMSUM_REL) and the threshold within THRESHOLD_ATOL.
"""
import copy
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.data.sample import FlowSample as JFlowSample
from liso_tpu.data.sample import PointCloud as JPointCloud
from liso_tpu.models.slim import movavg_init as j_movavg_init
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu.ops.boxes import Boxes as JBoxes
from liso_tpu.parallel.mesh import make_mesh as j_make_mesh
from liso_tpu.parallel.mesh import shard_batch as j_shard_batch
from liso_tpu.train.detector_train import DetectorTrainer as JDetTrainer
from liso_tpu.train.detector_train import DetectorTrainState
from liso_tpu.train.slim_train import SlimTrainer as JSlimTrainer
from liso_tpu.train.slim_train import SlimTrainState
from liso_tpu_torch.models.pillar_encoder import prepare_pillar_inputs
from liso_tpu_torch.models.slim import MovAvgState, movavg_value
from liso_tpu_torch.parallel import dryrun
from liso_tpu_torch.parallel.mesh import RankProcesses, map_tree
from liso_tpu_torch.train.liso_loop import cudnn_deterministic
from liso_tpu_torch.weights import (
    flax_state_dict,
    load_detector_train_state,
    load_slim_train_state,
)
from test_torch_modules import random_variables
from test_torch_parallel_ranks import (
    DET_CFG,
    NETWORKS,
    SLIM_CFG,
    WORLD,
    det_batch,
    det_bev,
    det_data,
    det_trainer,
    run_cases,
    run_det_step,
    run_slim_step,
    slim_batch,
    slim_bev,
    slim_data,
    slim_trainer,
)

torch.set_num_threads(1)
SLIM_LOSS_RTOL = 1e-4
DET_LOSS_RTOL = 5e-5
GRAD_NORM_RTOL = 1e-3
STATS_RTOL = 1e-6
GRAD_REL = 3e-2
NU_REL = 2 * GRAD_REL
UPDATE_GLOBAL_REL = 0.1
JAX_SLIM_LOSS_RTOL = 3e-4
JAX_DET_LOSS_RTOL = 1e-4
CUMSUM_REL = 1e-3
THRESHOLD_ATOL = 5e-5
# biases whose gradient is 0 in exact arithmetic (a norm follows them):
# held to ZERO_GRAD_REL of their weight's gradient norm
NORMED_BIAS = re.compile(
    r"(raft\.joint\.(conv1|layer\w+\.(conv1|conv2|down))"
    r"|model\.sep_head\.fused_conv0)\.bias$")
ZERO_GRAD_REL = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _rel(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp(min=1e-30))


def _slim_jax_state(data):
    """A random JAX SLIM state at step 1 (learning rate > 0: the schedule
    is 0 at step 0), RMSprop's nu at 0, and the JAX trainer and batch."""
    p0, v0, p1, v1, eye = data
    jt = JSlimTrainer(JBev((40.0, 40.0), (32, 32)), **SLIM_CFG)
    jbatch = JFlowSample(JPointCloud(jnp.asarray(p0), jnp.asarray(v0)),
                         JPointCloud(jnp.asarray(p1), jnp.asarray(v1)),
                         jnp.asarray(eye), jnp.asarray(eye))
    v = random_variables(jt.model.init, jbatch.pcl_t0.pcl, jbatch.pcl_t0.valid,
                         jbatch.pcl_t1.pcl, jbatch.pcl_t1.valid, seed=21)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    opt = jt.tx.init(params)
    opt = (opt[0], opt[1]._replace(count=jnp.asarray(1, jnp.int32)), opt[2])
    state = SlimTrainState(
        step=jnp.asarray(1, jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
        opt_state=opt, movavg=j_movavg_init(SLIM_CFG["num_train_samples"]))
    return jt, jbatch, _np(state)


def _det_jax_state(net, data):
    pts, valid, boxes = data
    jt = JDetTrainer(JBev((40.0, 40.0), (64, 64)),
                     use_baseline_parameters=net == "baseline", **DET_CFG)
    jp, jv = jnp.asarray(pts), jnp.asarray(valid)
    jboxes = JBoxes(**{k: jnp.asarray(v) for k, v in boxes.items()})
    v = random_variables(jt.model.init, jp, jv, seed=31)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = DetectorTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
        opt_state=jt.tx.init(params))
    return jt, (jp, jv, jboxes), _np(state)


def _local_slim(state, batch):
    """What a rank-local normalisation gives: each shard's loss terms over
    its own denominators (averaged, as DDP averages), and the BN running
    statistics after rank 0's shard alone."""
    tt = slim_trainer()
    shares = []
    for r in range(WORLD):
        tt.load_state_dict(state)
        shard = map_tree(lambda t: t[r:r + 1], batch)
        with torch.no_grad():
            loss, _, metrics, _ = tt._forward_and_loss(shard, train=True)
        shares.append({**{k: float(v) for k, v in metrics.items()},
                       "loss": float(loss)})
        if r == 0:
            stats0 = {k: v.clone() for k, v in tt.model.named_buffers()}
    return ({k: np.mean([s[k] for s in shares]) for k in shares[0]}, stats0)


def _local_det(net, state, batch):
    dt = det_trainer(net)
    shares = []
    for r in range(WORLD):
        dt.load_state_dict(state)
        pts, valid, boxes = map_tree(lambda t: t[r:r + 1], batch)
        with torch.no_grad():
            losses = dt._loss(pts, valid, boxes, None)
        shares.append({k: float(v) for k, v in losses.items()})
        if r == 0:
            stats0 = {k: v.clone() for k, v in dt.model.named_buffers()}
    return ({k: np.mean([s[k] for s in shares]) for k in shares[0]}, stats0)


def _jax_slim_step(jt, jbatch, state, jmesh):
    st, m = jt.train_step(jax.tree_util.tree_map(jnp.asarray, state),
                          j_shard_batch(jmesh, jbatch))
    return {"state": _np(st), "metrics": {k: float(x) for k, x in m.items()}}


def _jax_det_loss_grads(jt, jbatch, state, jmesh, model):
    """JAX's loss terms, gradient and updated BN statistics with the batch
    sharded on the mesh (test_dp_equivalence.py's comparison), in the
    port's names."""
    @jax.jit
    def loss_grads(params, bs, pts, valid, boxes):
        def f(p):
            return jt._loss(p, bs, pts, valid, boxes, None, True)
        (_, (new_bs, losses, _)), g = jax.value_and_grad(
            f, has_aux=True)(params)
        return losses, g, new_bs

    losses, g, new_bs = loss_grads(state.params, state.batch_stats,
                                   *j_shard_batch(jmesh, jbatch))
    return {"losses": {k: float(x) for k, x in losses.items()},
            "grads": flax_state_dict(model, {"params": _np(g)}),
            "stats": flax_state_dict(model, {"batch_stats": _np(new_bs)})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    sdata, ddata = slim_data(), det_data()
    # the JAX states, carried into the port's trainers
    jslim, jsbatch, js0 = _slim_jax_state(sdata)
    tt = slim_trainer()
    load_slim_train_state(tt, {
        "step": js0.step, "params": js0.params,
        "batch_stats": js0.batch_stats, "nu": js0.opt_state[0].nu,
        "movavg": js0.movavg._asdict()})
    slim_state = copy.deepcopy(tt.state_dict())
    jdet, det_states = {}, {}
    for net in NETWORKS:
        jt, jb, s0 = _det_jax_state(net, ddata)
        jdet[net] = (jt, jb, s0)
        dt = det_trainer(net)
        load_detector_train_state(dt, {
            "step": s0.step, "params": s0.params,
            "batch_stats": s0.batch_stats, "mu": s0.opt_state[0].mu,
            "nu": s0.opt_state[0].nu, "count": s0.opt_state[0].count})
        det_states[net] = copy.deepcopy(dt.state_dict())

    # the ranks, the dry run (its own spawned processes) and the JAX
    # compiles run side by side with the port's references below
    ranks = RankProcesses(run_cases, WORLD, (slim_state, det_states),
                          backend="gloo",
                          workdir=tmp_path_factory.mktemp("ranks"),
                          timeout_s=600)
    mp = pytest.MonkeyPatch()
    mp.setenv("LISO_CORR_PATH", "fused")  # read by the JAX SLIM step only
    jmesh = j_make_mesh(2)
    try:
        with ThreadPoolExecutor(4) as pool:
            f_dry = pool.submit(dryrun.dryrun_multichip, 2, device="cpu",
                                workdir=tmp_path_factory.mktemp("dryrun"))
            f_slim = pool.submit(_jax_slim_step, jslim, jsbatch, js0, jmesh)
            f_det = {net: pool.submit(_jax_det_loss_grads, *jdet[net], jmesh,
                                      det_trainer(net).model)
                     for net in NETWORKS}
            # the port's one-process step on the full batch, and the local
            # normalisations
            tt.load_state_dict(slim_state)
            one = {"slim": run_slim_step(tt, slim_batch(sdata))}
            local = {"slim": _local_slim(slim_state, slim_batch(sdata))}
            for net in NETWORKS:
                dt = det_trainer(net)
                dt.load_state_dict(det_states[net])
                one[net] = run_det_step(dt, det_batch(ddata))
                local[net] = _local_det(net, det_states[net], det_batch(ddata))
            jax_res = {"slim": f_slim.result(),
                       **{net: f.result() for net, f in f_det.items()}}
            rank_res = ranks.join()
            try:
                dry = {"result": f_dry.result()}
            except Exception as e:  # reported by test_dryrun_multichip_cpu
                dry = {"error": e}
    finally:
        mp.undo()
        ranks.stop()
    return dict(ranks=rank_res, one=one, local=local, jax=jax_res, dry=dry,
                slim_state=slim_state, slim_model=tt.model)


# ---------------------------------------------------------------------------
def test_helpers(runs):
    """shard_batch gives each rank its contiguous rows and refuses an
    indivisible leading dim; replicate broadcasts rank 0's tensors (a
    nested state and a module); batch_sum's cotangent is summed over the
    ranks."""
    for r, res in enumerate(runs["ranks"]):
        h = res["helpers"]
        assert torch.equal(h["shard"]["x"],
                           torch.arange(12).reshape(6, 2)[3 * r:3 * r + 3])
        assert torch.equal(h["shard"]["pc"].pcl, torch.arange(6.0)[3 * r:3 * r + 3])
        assert h["shard"]["none"] is None
        assert "not divisible by the world size 2" in h["indivisible"]
        assert torch.equal(h["state"]["w"], torch.zeros(3))
        assert int(h["state"]["n"][0]) == 0 and h["state"]["k"] == r
        assert torch.equal(h["weight"], torch.zeros(2, 2))
        # y = x0 + x1 = 1 + 2; rank r's loss is (r + 1) y, so every x
        # gets 1 + 2
        assert h["sum"] == 3.0 and h["sum_grad"] == 3.0


def test_other_trainers_take_a_group(runs):
    """TransFusion, PointPillars and PointRCNN once refused a group; they
    now take it, every BatchNorm of their models with it. Their sharded
    steps are held by tests/test_torch_parallel_detectors.py."""
    for res in runs["ranks"]:
        for name, (msg, bn_grouped) in res["refusals"].items():
            assert msg is None and bn_grouped, (name, msg)


def test_shards_are_unbalanced():
    """The data gives the two ranks different valid-point, in-pillar and
    threshold-histogram counts, and (detector) one rank no box."""
    p0, v0, p1, v1, _ = slim_data()
    assert v0[0].sum() > 1.5 * v0[1].sum() and v1[0].sum() > 1.5 * v1[1].sum()
    batch = slim_batch(slim_data())
    inp = prepare_pillar_inputs(batch.pcl_t0.pcl, batch.pcl_t0.valid,
                                slim_bev()).in_pillar.sum(-1)
    assert int(inp[0]) > 2 * int(inp[1]) > 0
    # the threshold update's mass: every valid point of both frames
    mass = v0.sum(-1) + v1.sum(-1)
    assert mass[0] > 1.5 * mass[1]
    pts, valid, boxes = det_data()
    assert boxes["valid"].sum(-1).tolist() == [2, 0]
    assert valid[0].sum() > 1.2 * valid[1].sum()
    dinp = prepare_pillar_inputs(torch.from_numpy(pts), torch.from_numpy(valid),
                                 det_bev()).in_pillar.sum(-1)
    assert int(dinp[0]) != int(dinp[1])


def _check_grads(got, want, tol):
    bad = {}
    for k in want:
        if NORMED_BIAS.search(k):
            w = k[: -len("bias")] + "weight"
            for g in (got, want):
                if not float(g[k].norm()) <= ZERO_GRAD_REL * float(g[w].norm()):
                    bad[k] = float(g[k].norm())
        elif not _rel(got[k], want[k]) <= tol:
            bad[k] = _rel(got[k], want[k])
    assert not bad, bad


def _check_nu(got, want):
    bad = {k: _rel(got[k], want[k]) for k in want
           if not NORMED_BIAS.search(k) and not _rel(got[k], want[k]) <= NU_REL}
    assert not bad, bad


def _updates(params, state_params):
    keys = sorted(k for k in params if not NORMED_BIAS.search(k))
    return torch.cat([(params[k] - state_params[k]).reshape(-1) for k in keys])


def test_ranks_end_bitwise_equal(runs):
    """Every rank holds the same state after the step: the gradient and
    the losses are summed once and the updates run alike."""
    a, b = runs["ranks"]
    for case in ("slim", *NETWORKS):
        for coll in ("params", "nu", "buffers", "grads"):
            for k, v in a[case][coll].items():
                assert torch.equal(v, b[case][coll][k]), (case, coll, k)
        assert a[case]["metrics"] == b[case]["metrics"]
    for k, v in a["slim"]["movavg"].items():
        assert torch.equal(v, b["slim"]["movavg"][k])


def test_slim_step_matches_one_process(runs):
    """Loss terms, grad norm, gradient, RMSprop's update and moment, the BN
    running statistics and the threshold state of the 2-rank step against
    the port's one-process step on the full batch."""
    got, want = runs["ranks"][0]["slim"], runs["one"]["slim"]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(
            got["metrics"][k], w, atol=1e-7, err_msg=k,
            rtol=GRAD_NORM_RTOL if k == "grad_norm" else SLIM_LOSS_RTOL)
    _check_grads(got["grads"], want["grads"], GRAD_REL)
    _check_nu(got["nu"], want["nu"])
    p0 = runs["slim_state"]["model"]
    assert _rel(_updates(got["params"], p0),
                _updates(want["params"], p0)) <= UPDATE_GLOBAL_REL
    for k, w in want["buffers"].items():
        assert _rel(got["buffers"][k], w) <= STATS_RTOL, k
    gm, wm = got["movavg"], want["movavg"]
    np.testing.assert_allclose(float(gm["bias_counter"]),
                               float(wm["bias_counter"]), rtol=1e-6)
    assert float(wm["bias_counter"]) > 0
    assert _rel(torch.cumsum(gm["importance"].double(), 0),
                torch.cumsum(wm["importance"].double(), 0)) <= CUMSUM_REL
    assert abs(float(movavg_value(MovAvgState(**gm)))
               - float(movavg_value(MovAvgState(**wm)))) <= THRESHOLD_ATOL


def test_slim_step_matches_jax_sharded(runs):
    """The same step against the JAX step sharded on make_mesh(2): loss
    terms, grad norm, the parameters after RMSprop and its moment, the BN
    statistics and the threshold state."""
    got, j = runs["ranks"][0]["slim"], runs["jax"]["slim"]
    model, st = runs["slim_model"], j["state"]
    for k, w in j["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w,
                                   rtol=JAX_SLIM_LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    _check_nu(got["nu"], flax_state_dict(model,
                                          {"params": st.opt_state[0].nu}))
    jparams = flax_state_dict(model, {"params": st.params})
    p0 = runs["slim_state"]["model"]
    assert _rel(_updates(got["params"], p0),
                _updates(jparams, p0)) <= UPDATE_GLOBAL_REL
    for k, w in flax_state_dict(model, {"batch_stats": st.batch_stats}).items():
        assert _rel(got["buffers"][k], w) <= JAX_SLIM_LOSS_RTOL, k
    jm = st.movavg
    np.testing.assert_allclose(float(got["movavg"]["bias_counter"]),
                               float(jm.bias_counter), rtol=1e-6)
    assert _rel(torch.cumsum(got["movavg"]["importance"].double(), 0),
                torch.cumsum(torch.from_numpy(jm.importance).double(), 0)
                ) <= CUMSUM_REL


def test_slim_local_normalisation_misses(runs):
    """On these shards each rank's own normalisation (averaged, as DDP
    averages) misses the loss limit, and rank 0's own BN statistics miss
    the statistics limit."""
    want = runs["one"]["slim"]
    local, stats0 = runs["local"]["slim"]
    for k in ("loss", "knn_flow_loss", "static_flow_loss"):
        assert abs(local[k] - want["metrics"][k]) > (
            10 * SLIM_LOSS_RTOL * abs(want["metrics"][k])), k
    assert max(_rel(stats0[k], w) for k, w in want["buffers"].items()
               ) > 100 * STATS_RTOL


@pytest.mark.parametrize("net", NETWORKS)
def test_centerpoint_step_matches_one_process(runs, net):
    """Loss terms, grad norm, gradient, the BN running statistics and
    AdamW's moments of the 2-rank step against the one-process step."""
    got, want = runs["ranks"][0][net], runs["one"][net]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(
            got["metrics"][k], w, atol=1e-7, err_msg=k,
            rtol=GRAD_NORM_RTOL if k == "grad_norm" else DET_LOSS_RTOL)
    _check_grads(got["grads"], want["grads"], GRAD_REL)
    _check_nu(got["nu"], want["nu"])
    for k, w in want["buffers"].items():
        assert _rel(got["buffers"][k], w) <= STATS_RTOL, k


@pytest.mark.parametrize("net", NETWORKS)
def test_centerpoint_step_matches_jax_sharded(runs, net):
    """Loss terms, gradients and the updated BN statistics against JAX's
    loss and gradient sharded on make_mesh(2)."""
    got, j = runs["ranks"][0][net], runs["jax"][net]
    for k, w in j["losses"].items():
        np.testing.assert_allclose(got["metrics"][f"loss/{k}"], w,
                                   rtol=JAX_DET_LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    _check_grads(got["grads"], j["grads"], GRAD_REL)
    for k, w in j["stats"].items():
        assert _rel(got["buffers"][k], w) <= STATS_RTOL, k


@pytest.mark.parametrize("net", NETWORKS)
def test_centerpoint_local_normalisation_misses(runs, net):
    want = runs["one"][net]["metrics"]
    local, stats0 = runs["local"][net]
    for k in ("total", "probs", "dims", "pos"):
        assert abs(local[k] - want[f"loss/{k}"]) > (
            10 * DET_LOSS_RTOL * abs(want[f"loss/{k}"])), k
    assert max(_rel(stats0[k], w) for k, w in runs["one"][net]["buffers"].items()
               ) > 100 * STATS_RTOL


def test_dryrun_multichip_cpu(runs):
    """dryrun_multichip(2, device="cpu") end to end: every sharded loss
    curve falls (SLIM and the four detectors), each worker mines its own
    sequence, the merged DB is the same on both and the replicas end
    bitwise equal (it raises if not)."""
    dry = runs["dry"]
    assert "error" not in dry, dry.get("error")
    res = dry["result"]
    assert res["slim_losses"][-1] < res["slim_losses"][0]
    assert res["det_losses"][-1] < res["det_losses"][0]
    assert set(res["other_losses"]) == {"transfusion", "pointpillars",
                                         "pointrcnn"}
    for curve in res["other_losses"].values():
        assert curve[-1] < curve[0]
    assert min(res["shard_boxes"]) > 0
    assert res["merged_boxes"] == sum(res["shard_boxes"])


def test_dryrun_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multichip(2)


def test_cudnn_deterministic_restores(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    with cudnn_deterministic(False):
        assert not torch.backends.cudnn.deterministic
    with cudnn_deterministic():
        assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.deterministic
