"""Modules of the ported SLIM train step against their liso_tpu
counterparts, fp32, on shared numpy inputs: weighted Kabsch (values and
gradients, the hand-derived SVD backward), the head decoder, the
moving-average threshold (batched against sequential, and against JAX),
one iteration's loss, the masked batch norm in train mode, RAFT with the
static-aggregation weight branch (values and gradients), the learning-rate
schedule, the optax RMSprop update, and `predict_step`."""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.losses import slim_loss as jloss
from liso_tpu.models import raft as jraft
from liso_tpu.models import slim as jslim
from liso_tpu.models import slim_decoder as jdec
from liso_tpu.models.pillar_encoder import MaskedBatchNorm as JMaskedBN
from liso_tpu.ops import kabsch as jkab
from liso_tpu.utils.schedules import polynomial_decay_with_warmup as j_sched
from liso_tpu_torch.losses import slim_loss as tloss
from liso_tpu_torch.models import raft, slim, slim_decoder as tdec
from liso_tpu_torch.models.pillar_encoder import MaskedBatchNorm
from liso_tpu_torch.ops import kabsch as tkab
from liso_tpu_torch.ops.bev import BevSetup, voxel_center_coords
from liso_tpu_torch.train.slim_train import rmsprop_update_
from liso_tpu_torch.utils.schedules import polynomial_decay_with_warmup
from liso_tpu_torch.weights import flax_state_dict, load_flax_variables
from test_torch_modules import random_variables

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n_weighted", [40, 2])
def test_weighted_kabsch_values_and_grads(n_weighted):
    """With 2 weighted points (< 3) every weight gets EPSILON added and
    `not_enough_points` is set, as in the reference. The cross-covariance
    is then of rank 1 up to the EPSILON-weighted points (singular values
    1e-7 of the largest, fp32's own precision), so the rotation about the
    two points' axis is rounding noise on either side: there both give a
    finite rigid transform and finite gradients, not the same ones."""
    rng = np.random.RandomState(n_weighted)
    b, n = 2, 40
    x = rng.uniform(-10, 10, (b, n, 3)).astype(np.float32)
    ang = 0.3
    rot = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                    [0, 0, 1]], np.float32)
    y = (x @ rot.T + [1.0, -2.0, 0.5] + rng.normal(0, 0.1, x.shape)).astype(np.float32)
    w = rng.rand(b, n).astype(np.float32)
    w[:, n_weighted:] = 0.0
    g = rng.randn(b, 4, 4).astype(np.float32)

    def jf(x, y, w):
        T, bad = jkab.weighted_kabsch(x, y, w)
        return jnp.sum(T * g), (T, bad)

    (_, (jT, jbad)), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                                 has_aux=True)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    tx, ty, tw = (_t(a).requires_grad_() for a in (x, y, w))
    tT, tbad = tkab.weighted_kabsch(tx, ty, tw)
    (tT * _t(g)).sum().backward()
    np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
    assert bool(tbad.all()) == (n_weighted < 3)
    if n_weighted < 3:
        for T in (tT.detach().numpy(), np.asarray(jT)):
            R = T[:, :3, :3]
            np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                                       np.tile(np.eye(3), (b, 1, 1)), atol=1e-4)
            np.testing.assert_array_equal(T[:, 3], [[0, 0, 0, 1]] * b)
        assert all(bool(torch.isfinite(t.grad).all()) for t in (tx, ty, tw))
        return
    np.testing.assert_allclose(tT.detach().numpy(), np.asarray(jT), atol=2e-5)
    for got, want in zip((tx.grad, ty.grad, tw.grad), jgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max())


def _decode_inputs(seed=0, b=2, h=16, w=16, n=300):
    rng = np.random.RandomState(seed)
    out = rng.randn(b, h, w, 9).astype(np.float32)
    out[..., 4:8] *= 2.0
    pc = rng.uniform(-9, 9, (b, n, 4)).astype(np.float32)
    rowcol = rng.randint(-1, h + 1, (b, n, 2)).astype(np.int32)
    valid = rng.rand(b, n) > 0.1
    filled = rng.rand(b, h, w) > 0.3
    odom = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    odom[:, 0, 3] = [0.4, -0.2]
    odom[:, :2, :2] = [[0.998, -0.05], [0.05, 0.998]]
    return out, pc, rowcol, valid, filled, odom


def test_decode_matches_jax():
    """slim_liso flags; every field of SlimPrediction, and the gradient of
    a weighted sum of the float fields wrt the network output."""
    out, pc, rowcol, valid, filled, odom = _decode_inputs()
    bev = BevSetup((20.0, 20.0), (16, 16))
    vc = voxel_center_coords(bev)
    jcfg = jdec.DecoderCfg(predict_weight_for_static_aggregation="sigmoid",
                           use_static_aggr_flow_for_aggr_flow=True)
    tcfg = tdec.DecoderCfg(predict_weight_for_static_aggregation="sigmoid",
                           use_static_aggr_flow_for_aggr_flow=True)
    fields = [f for f in jdec.SlimPrediction._fields
              if f not in ("is_static", "is_dynamic", "is_ground",
                           "not_enough_points", "dynamicness_threshold")]
    wts = {f: np.random.RandomState(len(f)).randn(1).astype(np.float32)[0]
           for f in fields}

    def jf(o):
        p = jdec.decode(o, jnp.float32(0.45), cfg=jcfg, pc=jnp.asarray(pc),
                        rowcol=jnp.asarray(rowcol), point_valid=jnp.asarray(valid),
                        filled_pillar_mask=jnp.asarray(filled),
                        inv_odom=jnp.asarray(odom), voxel_center_xy=np.asarray(vc))
        return sum(jnp.sum(getattr(p, f)) * wts[f] for f in fields), p

    (_, jp), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(out))
    to = _t(out).requires_grad_()
    tp = tdec.decode(to, torch.tensor(0.45), cfg=tcfg, pc=_t(pc), rowcol=_t(rowcol),
                     point_valid=_t(valid), filled_pillar_mask=_t(filled),
                     inv_odom=_t(odom), voxel_center_xy=vc)
    sum((getattr(tp, f).sum() * float(wts[f]) for f in fields)).backward()
    for f in jdec.SlimPrediction._fields:
        got, want = getattr(tp, f).detach().numpy(), np.asarray(getattr(jp, f))
        if want.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(to.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jg)).max())


def _movavg_rows(seed, i=3, m=4000, res=100_000):
    rng = np.random.RandomState(seed)
    es = rng.rand(i, m).astype(np.float32) * 2
    ed = rng.rand(i, m).astype(np.float32) * 2
    dyn = rng.rand(i, m).astype(np.float32)
    dyn[:, :100] = 0.25  # a crowded bin
    valid = rng.rand(i, m) > 0.1
    return es, ed, dyn, valid


@pytest.mark.parametrize("empty_row", [False, True])
def test_movavg_batched_matches_sequential_and_jax(empty_row):
    """With `empty_row`, one iteration's row has no valid entry: its fold
    has count 0 and leaves the state as it was."""
    es, ed, dyn, valid = _movavg_rows(0)
    if empty_row:
        valid[1] = False
    st0 = slim.movavg_init(10)
    seq = st0
    for i in range(es.shape[0]):
        seq = slim.movavg_update(seq, _t(es[i]), _t(ed[i]), _t(dyn[i]), _t(valid[i]))
    bat = slim.movavg_update_batched(st0, _t(es), _t(ed), _t(dyn), _t(valid))
    jst = jslim.movavg_update_batched(jslim.movavg_init(10), *map(jnp.asarray,
                                                                  (es, ed, dyn, valid)))
    # the sequential and batched folds are the same fp32 operations
    np.testing.assert_array_equal(bat.importance.numpy(), seq.importance.numpy())
    assert float(bat.bias_counter) == float(seq.bias_counter)
    # against JAX: per-bin fp32 sums in another order (segment_sum there)
    np.testing.assert_allclose(bat.importance.numpy(), np.asarray(jst.importance),
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(float(bat.bias_counter), float(jst.bias_counter),
                               rtol=1e-6)
    assert float(slim.movavg_value(bat)) == pytest.approx(
        float(jslim.movavg_value(jst)), abs=1e-5)
    assert float(slim.movavg_value(st0)) == 0.5


def test_slim_loss_single_iteration_matches_jax():
    """One iteration's loss and metrics from decoded predictions, with the
    1-NN searches run inside (exact on both sides) and the threshold
    update, and the gradient wrt the network outputs."""
    rng = np.random.RandomState(5)
    b, h, n = 2, 16, 300
    bev = BevSetup((20.0, 20.0), (h, h))
    vc = voxel_center_coords(bev)
    outs = [rng.randn(b, h, h, 9).astype(np.float32) for _ in range(2)]
    pcs = [rng.uniform(-9, 9, (b, n, 4)).astype(np.float32) for _ in range(2)]
    valids = [rng.rand(b, n) > 0.1 for _ in range(2)]
    rcs = [np.floor((p[..., :2] + 10.0) / 1.25).astype(np.int32) for p in pcs]
    filled = rng.rand(b, h, h) > 0.3
    odom = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    kw = dict(use_static_aggr_flow_for_aggr_flow=True,
              bev_extent=(-10.0, -10.0, 10.0, 10.0))
    jcfg = jloss.SlimLossCfg(knn_chunk=256, **kw)
    tcfg = tloss.SlimLossCfg(**kw)
    jd = jdec.DecoderCfg(predict_weight_for_static_aggregation="sigmoid",
                         use_static_aggr_flow_for_aggr_flow=True)
    td = tdec.DecoderCfg(predict_weight_for_static_aggregation="sigmoid",
                         use_static_aggr_flow_for_aggr_flow=True)

    def jf(o0, o1):
        preds = [jdec.decode(o, jnp.float32(0.5), cfg=jd, pc=jnp.asarray(p),
                             rowcol=jnp.asarray(rc), point_valid=jnp.asarray(v),
                             filled_pillar_mask=jnp.asarray(filled),
                             inv_odom=jnp.asarray(odom), voxel_center_xy=np.asarray(vc))
                 for o, p, rc, v in zip((o0, o1), pcs, rcs, valids)]
        loss, mv, m = jloss.slim_loss_single_iteration(
            preds[0], preds[1], jnp.asarray(pcs[0]), jnp.asarray(valids[0]),
            jnp.asarray(pcs[1]), jnp.asarray(valids[1]), jslim.movavg_init(10), jcfg)
        return loss, (mv, m)

    (jl, (jmv, jm)), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        *map(jnp.asarray, outs))
    tos = [_t(o).requires_grad_() for o in outs]
    preds = [tdec.decode(o, torch.tensor(0.5), cfg=td, pc=_t(p), rowcol=_t(rc),
                         point_valid=_t(v), filled_pillar_mask=_t(filled),
                         inv_odom=_t(odom), voxel_center_xy=vc)
             for o, p, rc, v in zip(tos, pcs, rcs, valids)]
    tl, tmv, tm = tloss.slim_loss_single_iteration(
        preds[0], preds[1], _t(pcs[0]), _t(valids[0]), _t(pcs[1]), _t(valids[1]),
        slim.movavg_init(10), tcfg)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k].detach()) == pytest.approx(float(jm[k]), rel=1e-5,
                                                      abs=1e-7), k
    assert float(tmv.bias_counter) == pytest.approx(float(jmv.bias_counter), rel=1e-6)
    for got, want in zip(tos, jg):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_masked_batch_norm_train_mode():
    """Statistics over the masked points only, biased variance; running
    statistics with flax's momentum 0.99; the gradient wrt x."""
    rng = np.random.RandomState(6)
    x = (rng.randn(2, 500, 8) * 3 + 1).astype(np.float32)
    mask = rng.rand(2, 500) > 0.3
    g = rng.randn(*x.shape).astype(np.float32)
    jm = JMaskedBN()
    v = random_variables(lambda k, *a: jm.init(k, *a, train=False),
                         jnp.asarray(x), jnp.asarray(mask), seed=7)

    def jf(x):
        y, mut = jm.apply(v, x, jnp.asarray(mask), True, mutable=["batch_stats"])
        return jnp.sum(y * g), mut

    (_, mut), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    bn = MaskedBatchNorm(8)
    sd = flax_state_dict(bn, v)
    bn.load_state_dict(sd)
    bn.train()
    tx = _t(x).requires_grad_()
    (bn(tx, _t(mask)) * _t(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)
    new = flax_state_dict(bn, {"batch_stats": mut["batch_stats"]})
    for k, want in new.items():
        np.testing.assert_allclose(bn.state_dict()[k].numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_raft_weight_branch_values_and_grads(monkeypatch):
    """RAFT with predict_weight_for_static_aggregation: 9 output channels,
    the 3-channel flow input filled by the weight bridge; outputs and every
    parameter's gradient of a weighted output sum (fused corr on both
    sides). Conv biases that feed an instance norm have a gradient of 0 up
    to rounding and are compared absolutely."""
    monkeypatch.setenv("LISO_CORR_PATH", "fused")
    rng = np.random.RandomState(4)
    img0 = rng.randn(1, 32, 32, 8).astype(np.float32)
    img1 = img0 + 0.3 * rng.randn(*img0.shape).astype(np.float32)
    jm = jraft.RAFT(num_iters=2, corr_levels=4, resolution_m=1.0,
                    predict_weight_for_static_aggregation=True)
    v = random_variables(jm.init, jnp.asarray(img0), jnp.asarray(img1), seed=5)
    shape = jax.eval_shape(lambda: jm.apply(v, jnp.asarray(img0), jnp.asarray(img1)))
    w = rng.randn(*shape.shape).astype(np.float32)
    f = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(img0),
                                   jnp.asarray(img1)) * w)))
    jl, jg = f(v["params"])
    tm = load_flax_variables(raft.RAFT((32, 32), in_channels=8, num_iters=2,
                                       resolution_m=1.0,
                                       predict_weight_for_static_aggregation=True), v)
    out = tm(_t(img0), _t(img1))
    assert tuple(out.shape) == shape.shape and out.shape[-1] == 9
    (out * _t(w)).sum().backward()
    assert float((out * _t(w)).sum().detach()) == pytest.approx(float(jl), rel=1e-5)
    want = flax_state_dict(tm, {"params": jax.tree_util.tree_map(np.asarray, jg)})
    for k, p in tm.named_parameters():
        ref = float(want[k].norm())
        err = float((p.grad - want[k]).norm())
        if k.startswith("joint.") and k.endswith(".bias") and "norm" not in k \
                and "head" not in k:
            assert err <= 1e-6 * float(want[k[:-4] + "weight"].norm()), k
        else:
            assert err <= 1e-3 * ref, (k, err / ref)


def test_schedule_and_rmsprop_match_optax():
    sched_j = j_sched(1e-4, 20, 100)
    sched_t = polynomial_decay_with_warmup(1e-4, 20, 100)
    for s in (0, 1, 19, 20, 21, 60, 100, 150):
        assert float(sched_t(s)) == float(sched_j(s)), s
    rng = np.random.RandomState(8)
    params = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    tx = optax.rmsprop(sched_j)
    state = tx.init(jax.tree_util.tree_map(jnp.asarray, params))
    tp = {k: _t(v) for k, v in params.items()}
    tnu = {k: torch.zeros_like(v) for k, v in tp.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    for step in range(25):
        grads = {k: (rng.randn(*v.shape) * 10.0 ** rng.uniform(-6, 1)).astype(np.float32)
                 for k, v in params.items()}
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, upd)
        rmsprop_update_(list(tp.values()), [_t(grads[k]) for k in tp],
                        list(tnu.values()), sched_t(step))
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-9)
            np.testing.assert_allclose(tnu[k].numpy(), np.asarray(state[0].nu[k]),
                                       rtol=1e-6)


def test_predict_step_matches_jax(monkeypatch):
    """predict_step: the final iteration's decoded prediction with the
    batch norm's running statistics, restored to the caller's point order
    (both sides run on cell-sorted points)."""
    from liso_tpu.data.sample import FlowSample as JFS, PointCloud as JPC
    from liso_tpu.ops.bev import BevSetup as JBev
    from liso_tpu.train.slim_train import SlimTrainer as JTrainer
    from liso_tpu.train.slim_train import SlimTrainState
    from liso_tpu_torch.data.sample import FlowSample, PointCloud
    from liso_tpu_torch.train.slim_train import SlimTrainer
    from liso_tpu_torch.weights import load_slim_train_state

    monkeypatch.setenv("LISO_CORR_PATH", "fused")
    rng = np.random.RandomState(9)
    b, n = 2, 1024
    pts = [rng.uniform(-18, 18, (b, n, 4)).astype(np.float32) for _ in range(2)]
    for p in pts:
        p[..., 2] = rng.uniform(-4, 4, (b, n))
    valid = [rng.rand(b, n) > 0.05 for _ in range(2)]
    eye = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    kw = dict(num_iters=2, predict_weight_for_static_aggregation="sigmoid",
              use_static_aggr_flow_for_aggr_flow=True)
    jt = JTrainer(JBev((40.0, 40.0), (32, 32)), **kw)
    jb = JFS(JPC(jnp.asarray(pts[0]), jnp.asarray(valid[0])),
             JPC(jnp.asarray(pts[1]), jnp.asarray(valid[1])),
             jnp.asarray(eye), jnp.asarray(eye))
    v = random_variables(jt.model.init, jb.pcl_t0.pcl, jb.pcl_t0.valid,
                         jb.pcl_t1.pcl, jb.pcl_t1.valid, seed=10)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    st = SlimTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                           v["batch_stats"]),
                        opt_state=jt.tx.init(params),
                        movavg=jslim.movavg_init(1))
    want = jt.predict_step(st, jb)
    tt = SlimTrainer(BevSetup((40.0, 40.0), (32, 32)), device="cpu", **kw)
    load_slim_train_state(tt, {"step": 0, "params": v["params"],
                               "batch_stats": v["batch_stats"],
                               "nu": jax.tree_util.tree_map(np.asarray,
                                                            st.opt_state[0].nu),
                               "movavg": st.movavg._asdict()})
    got = tt.predict_step(FlowSample(PointCloud(_t(pts[0]), _t(valid[0])),
                                     PointCloud(_t(pts[1]), _t(valid[1])),
                                     _t(eye), _t(eye)))
    for g, w in zip(got, want):
        for f in tdec.SlimPrediction._fields:
            a, e = getattr(g, f).numpy(), np.asarray(getattr(w, f))
            if e.dtype == bool:
                assert (a != e).mean() < 1e-3, f  # flow-threshold ties
            else:
                np.testing.assert_allclose(a, e, rtol=1e-4, atol=2e-3, err_msg=f)
