"""The ported SLIM train step as a whole: liso_tpu_torch.train.slim_train.
SlimTrainer.train_step against the JAX SlimTrainer.train_step
(liso_tpu/train/slim_train.py:275-298) at the slim_liso flags
(predict_weight_for_static_aggregation="sigmoid",
use_static_aggr_flow_for_aggr_flow=True), fp32, cut to grid 32 over 40 m,
two RAFT iterations, batch 2, 2048 points per frame. Both sides start from
the same random flax state (carried across by liso_tpu_torch.weights.
load_slim_train_state) and take three steps on the same batch.

The JAX side runs under LISO_CORR_PATH=fused, so both round corr to bf16
and take the fused backward's bf16 cotangent (the Pallas kernels in
interpret mode). On the CPU the JAX step scatters with segment_max, finds
neighbours with the exact brute force and bins the threshold histogram
with segment_sum; the port runs its kernels' plain versions (TPU VJP of the
scatter-max, exact 1-NN, sort + index_add_).

The JAX step is compiled once and called six times: three steps, and a
gradient probe from each of the three states. A probe starts from the
state with nu = 0 and the optimizer's schedule count at 1, so that its
learning rate is not 0; one RMSprop step then gives nu1 = 0.1 g^2 and
p1 - p0 = -lr g rsqrt(nu1 + eps), so the JAX gradient is
g = -sign(p1 - p0) sqrt(10 nu1), without a second compile.

The port runs each step twice: from the JAX state of that step (the
per-step comparisons), and free running from state 0 (the metrics).
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.data.sample import FlowSample as JFlowSample
from liso_tpu.data.sample import PointCloud as JPointCloud
from liso_tpu.models.slim import movavg_init as j_movavg_init
from liso_tpu.models.slim import movavg_value as j_movavg_value
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu.train.slim_train import SlimTrainer as JTrainer
from liso_tpu.train.slim_train import SlimTrainState
from liso_tpu_torch.data.sample import FlowSample, PointCloud
from liso_tpu_torch.models.slim import movavg_value
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.train.slim_train import SlimTrainer
from liso_tpu_torch.weights import flax_state_dict, load_slim_train_state
from test_torch_modules import random_variables

torch.set_num_threads(1)
GRID, RANGE, ITERS, B, N, STEPS = 32, 40.0, 2, 2, 2048, 3
CFG = dict(
    num_iters=ITERS, predict_weight_for_static_aggregation="sigmoid",
    use_static_aggr_flow_for_aggr_flow=True, num_train_samples=10,
    warmup_steps=2, train_steps=10, initial_lr=1e-6,
)
# The learning rate is cut to 1e-6 so that the three states stay close to
# each other: the first RMSprop steps are sign steps of lr sqrt(10) per
# element, and at the default 1e-4 the loss of this random network moves
# from 201 to 24 in one step. The update rule is tested all the same (the
# parameter changes are compared relatively, and test_torch_slim_modules
# holds it to optax on fixed gradients).
#
# Tolerances, fp32 on both sides, and why:
# - The two sides sum in other orders (convs, corr dots, Kabsch sums). On
#   this data the loss terms of states 0 and 1 agree to 4e-7 and every
#   gradient tensor to 2.2e-4 of its norm. But corr is rounded to bf16, so
#   a dot whose last fp32 bit differs can round to the neighbouring bf16
#   value (2^-8 relative) when it sits on a rounding boundary, and that one
#   tap moves through the GRU: in state 2 the loss terms then differ by
#   9e-5 and the gradients by up to 1.2e-2 of a tensor's norm.
LOSS_RTOL = 3e-4
GRAD_REL = 3e-2  # |g_port - g_jax| / |g_jax| per tensor
# - Biases of the encoder convs that feed an instance norm have a gradient
#   of exactly 0 in exact arithmetic (the norm removes a per-channel
#   constant); both sides give rounding noise, 1e-8 of the conv weight's
#   gradient norm. They are held to that bound, not compared, and their
#   RMSprop updates and moments (noise scaled to a full step) are skipped.
NORMED_BIAS = re.compile(r"raft\.joint\.(conv1|layer\w+\.(conv1|conv2|down))\.bias$")
ZERO_GRAD_REL = 1e-6
# - RMSprop normalises each element: an element whose gradient is within
#   the gradient's absolute error of 0 still takes a step of up to
#   lr sqrt(10), so the parameter change inherits the gradient's error
#   amplified; its moment nu = 0.1 g^2 + 0.9 nu doubles the relative error.
UPDATE_REL = 0.1
NU_REL = 2 * GRAD_REL
# - The dynamicness threshold is the argmin over a 100000-bin histogram of
#   fp32 dynamicness values: one value that lands in the neighbouring bin
#   moves one improvement by one bin, so the histograms are compared by
#   their cumulative sums, and the threshold they give within a few bins.
CUMSUM_REL = 1e-3
THRESHOLD_ATOL = 5e-5  # five bins of 1e-5


def _batch(seed):
    """Two frames of a small scene: uniform points inside the 40 m grid,
    |z| < 4 m (so most points reach a pillar), a few invalid ones; frame
    1 is frame 0 moved by (0.6, -0.4) m with its own noise."""
    rng = np.random.RandomState(seed)
    p0 = rng.uniform(-18, 18, (B, N, 4)).astype(np.float32)
    p0[..., 2] = rng.uniform(-4, 4, (B, N))
    p1 = p0 + rng.normal(0, 0.05, p0.shape).astype(np.float32)
    p1[..., :2] += np.array([0.6, -0.4], np.float32)
    v0, v1 = rng.rand(B, N) > 0.05, rng.rand(B, N) > 0.05
    eye = np.tile(np.eye(4, dtype=np.float32)[None], (B, 1, 1))
    return p0, v0, p1, v1, eye


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _flat(d):
    return {k: v.detach().clone() for k, v in d.items()}


@pytest.fixture(scope="module")
def runs():
    """Three JAX steps, the JAX gradient at the first state, and the same
    three steps of the port (grads of its first step kept)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LISO_CORR_PATH", "fused")
    try:
        p0, v0, p1, v1, eye = _batch(0)
        jb = JBev((RANGE, RANGE), (GRID, GRID))
        jt = JTrainer(jb, **CFG)
        jbatch = JFlowSample(JPointCloud(jnp.asarray(p0), jnp.asarray(v0)),
                             JPointCloud(jnp.asarray(p1), jnp.asarray(v1)),
                             jnp.asarray(eye), jnp.asarray(eye))
        v = random_variables(jt.model.init, jbatch.pcl_t0.pcl,
                             jbatch.pcl_t0.valid, jbatch.pcl_t1.pcl,
                             jbatch.pcl_t1.valid, seed=21)
        params = jax.tree_util.tree_map(jnp.asarray, v["params"])
        state0 = SlimTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
            opt_state=jt.tx.init(params),
            movavg=j_movavg_init(CFG["num_train_samples"]),
        )
        s0 = _np(state0)

        def fresh(s):  # train_step donates its state
            return jax.tree_util.tree_map(jnp.asarray, s)

        jstates, jmetrics = [s0], []
        for _ in range(STEPS):
            st, m = jt.train_step(fresh(jstates[-1]), jbatch)
            jstates.append(_np(st))
            jmetrics.append({k: float(x) for k, x in m.items()})
        # gradient probes (module docstring): from each state k with nu = 0
        # and the schedule count at 1
        probes = []
        for st in jstates[:STEPS]:
            probe_in = fresh(st)
            probe_in = probe_in.replace(opt_state=(
                probe_in.opt_state[0]._replace(nu=jax.tree_util.tree_map(
                    jnp.zeros_like, probe_in.opt_state[0].nu)),
                probe_in.opt_state[1]._replace(count=jnp.asarray(1, jnp.int32)),
                probe_in.opt_state[2]))
            probes.append(_np(jt.train_step(probe_in, jbatch)[0]))
    finally:
        mp.undo()

    def as_port(s):
        return {"step": s.step, "params": s.params,
                "batch_stats": s.batch_stats, "nu": s.opt_state[0].nu,
                "movavg": s.movavg._asdict()}

    tbatch = FlowSample(
        PointCloud(torch.from_numpy(p0), torch.from_numpy(v0)),
        PointCloud(torch.from_numpy(p1), torch.from_numpy(v1)),
        torch.from_numpy(eye), torch.from_numpy(eye))
    # per step: the port's step k from JAX state k
    tt = SlimTrainer(BevSetup((RANGE, RANGE), (GRID, GRID)), device="cpu", **CFG)
    synced = []
    for k in range(STEPS):
        load_slim_train_state(tt, as_port(jstates[k]))
        p_before = _flat(tt.params)
        m = tt.train_step(tbatch)
        synced.append(dict(
            metrics={n: float(x) for n, x in m.items()},
            grads={n: p.grad.clone() for n, p in tt.params.items()},
            update={n: p.detach() - p_before[n] for n, p in tt.params.items()},
            nu=_flat(tt.nu), movavg=tt.movavg, step=tt.step,
            state=_flat(tt.model.state_dict()),
        ))
    # free running: three steps of the port from JAX state 0
    load_slim_train_state(tt, as_port(jstates[0]))
    free = [{n: float(x) for n, x in tt.train_step(tbatch).items()}
            for _ in range(STEPS)]

    # the JAX gradient at each state, from the probe steps
    model = tt.model
    jgrads = []
    for st, pr in zip(jstates, probes):
        nu1 = flax_state_dict(model, {"params": pr.opt_state[0].nu})
        dp = {k: a - b for k, (a, b) in _zip(
            flax_state_dict(model, {"params": pr.params}),
            flax_state_dict(model, {"params": st.params}))}
        jgrads.append({k: -torch.sign(dp[k])
                       * torch.sqrt(nu1[k].double() / 0.1).float() for k in nu1})
    return dict(jstates=jstates, jmetrics=jmetrics, jgrads=jgrads,
                model=model, synced=synced, free=free)


def _zip(a, b):
    assert set(a) == set(b)
    return [(k, (a[k], b[k])) for k in a]


def _rel(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp(min=1e-30))


def _jax(runs, k, coll, tree=None):
    """JAX state k's `coll` ("params", "batch_stats" or "nu") in the
    port's names and layout."""
    st = runs["jstates"][k]
    if coll == "nu":
        return flax_state_dict(runs["model"], {"params": st.opt_state[0].nu})
    return flax_state_dict(runs["model"], {coll: getattr(st, coll)})


def test_metrics_every_step(runs):
    """Loss terms, loss, grad norm and learning rate of each step, from the
    same JAX state and free running from state 0."""
    for step in range(STEPS):
        want = runs["jmetrics"][step]
        for got in (runs["synced"][step]["metrics"], runs["free"][step]):
            assert set(got) == set(want), step
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                           atol=1e-7, err_msg=f"step {step} {k}")
    assert runs["free"][0]["lr"] == 0.0 and runs["free"][1]["lr"] > 0


@pytest.mark.parametrize("step", range(STEPS))
def test_gradients_per_tensor(runs, step):
    """Every parameter's gradient at each state, by relative norm."""
    got, want = runs["synced"][step]["grads"], runs["jgrads"][step]
    bad = {}
    for k in want:
        if NORMED_BIAS.match(k):
            w = k[: -len("bias")] + "weight"
            for g in (got, want):
                if not float(g[k].norm()) <= ZERO_GRAD_REL * float(g[w].norm()):
                    bad[k] = float(g[k].norm())
        elif not _rel(got[k], want[k]) <= GRAD_REL:
            bad[k] = _rel(got[k], want[k])
    assert not bad, bad
    assert len(want) == len(got) == sum(1 for _ in runs["model"].parameters())


@pytest.mark.parametrize("step", range(STEPS))
def test_state_after_each_step(runs, step):
    """From JAX state k, one port step gives JAX state k + 1: the
    parameter update, the RMSprop moment, the BN running statistics, the
    step count and the threshold state. After step 0 (learning rate 0)
    the parameters must not move."""
    got = runs["synced"][step]
    p0, p1 = _jax(runs, step, "params"), _jax(runs, step + 1, "params")
    nu = _jax(runs, step + 1, "nu")
    bad = {}
    for k, u in got["update"].items():
        if step == 0:
            if bool((u != 0).any()):
                bad[k] = "moved at lr 0"
            continue
        if NORMED_BIAS.match(k):
            continue
        if not _rel(u, p1[k] - p0[k]) <= UPDATE_REL:
            bad[k] = ("update", _rel(u, p1[k] - p0[k]))
    for k, v in got["nu"].items():
        if not NORMED_BIAS.match(k) and not _rel(v, nu[k]) <= NU_REL:
            bad[k] = ("nu", _rel(v, nu[k]))
    assert not bad, bad
    for k, want in _jax(runs, step + 1, "batch_stats").items():
        assert _rel(got["state"][k], want) <= LOSS_RTOL, k
    assert got["step"] == step + 1
    jm = runs["jstates"][step + 1].movavg
    np.testing.assert_allclose(float(got["movavg"].bias_counter),
                               float(jm.bias_counter), rtol=1e-6)
    assert float(jm.bias_counter) > 0
    want_imp = torch.from_numpy(jm.importance)
    assert _rel(torch.cumsum(got["movavg"].importance.double(), 0),
                torch.cumsum(want_imp.double(), 0)) <= CUMSUM_REL
    thr = movavg_value(got["movavg"])
    thr_jax = float(j_movavg_value(jm))
    assert abs(float(thr) - thr_jax) <= THRESHOLD_ATOL, (float(thr), thr_jax)
