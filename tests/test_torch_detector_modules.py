"""The detector-training modules of liso_tpu_torch against their liso_tpu
counterparts, fp32, on the same seeded numpy inputs: Boxes' methods,
centermap rendering, the centerpoint losses, rotated IoU, NMS, the OneCycle
schedule, train-mode BatchNorm and the AdamW update."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from liso_tpu.data import centermaps as jcm
from liso_tpu.losses import centerpoint_loss as jloss
from liso_tpu.models.box_decode import BoxPredictionCfg as JCfg
from liso_tpu.ops import iou as jiou
from liso_tpu.ops import nms as jnms
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu.ops.boxes import Boxes as JBoxes
from liso_tpu.utils.schedules import onecycle as j_onecycle
from liso_tpu_torch.data import centermaps as tcm
from liso_tpu_torch.losses import centerpoint_loss as tloss
from liso_tpu_torch.models.box_decode import BoxPredictionCfg
from liso_tpu_torch.models.layers import BatchNorm
from liso_tpu_torch.ops import iou as tiou
from liso_tpu_torch.ops import nms as tnms
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.train.detector_train import adamw_update_
from liso_tpu_torch.utils.schedules import onecycle

torch.set_num_threads(1)
FIELDS = ("pos", "dims", "rot", "probs", "velo", "valid", "class_id",
          "difficulty")


def _t(x):
    return torch.from_numpy(np.array(x))


def random_boxes(rng, b, k, valid_frac=0.8, spread=20.0):
    """numpy fields of B x K boxes: centers within +-spread m, car-like
    sizes, any yaw, probs in (0, 1)."""
    return dict(
        pos=rng.uniform(-spread, spread, (b, k, 3)).astype(np.float32),
        dims=rng.uniform([1.5, 1.0, 1.0], [6.0, 2.5, 2.0], (b, k, 3)).astype(np.float32),
        rot=rng.uniform(-np.pi, np.pi, (b, k, 1)).astype(np.float32),
        probs=rng.rand(b, k, 1).astype(np.float32),
        velo=rng.randn(b, k, 1).astype(np.float32),
        valid=rng.rand(b, k) < valid_frac,
        class_id=rng.randint(0, 4, (b, k, 1)).astype(np.int32),
        difficulty=rng.randint(0, 3, (b, k, 1)).astype(np.int32),
    )


def both(d):
    return (JBoxes(**{f: jnp.asarray(v) for f, v in d.items()}),
            Boxes(**{f: _t(v) for f, v in d.items()}))


def assert_boxes(got: Boxes, want, atol=0.0, fields=FIELDS):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is None:
            continue
        assert tuple(g.shape) == tuple(w.shape), f
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                       rtol=atol, err_msg=f)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)


def test_boxes_methods():
    """empty, take (with a validity mask), pad_to (pad and truncate),
    mask_invalid, concatenate and bev_corners: exact."""
    rng = np.random.RandomState(0)
    jb, tb = both(random_boxes(rng, 2, 6))
    jb2, tb2 = both(random_boxes(rng, 2, 3))
    assert_boxes(Boxes.empty(5, batch=(2,)), JBoxes.empty(5, batch=(2,)))
    idx = rng.randint(0, 6, (2, 4))
    ok = rng.rand(2, 4) < 0.7
    assert_boxes(tb.take(_t(idx), _t(ok)), jb.take(jnp.asarray(idx), jnp.asarray(ok)))
    assert_boxes(tb.take(_t(idx)), jb.take(jnp.asarray(idx)))
    for k in (9, 6, 4):
        assert_boxes(tb.pad_to(k), jb.pad_to(k))
    assert_boxes(tb.mask_invalid(), jb.mask_invalid())
    assert_boxes(tb.concatenate(tb2), jb.concatenate(jb2))
    np.testing.assert_allclose(tb.bev_corners().numpy(),
                               np.asarray(jb.bev_corners()), atol=1e-6)


BEV = ((40.0, 40.0), (64, 64))


def _scene_boxes():
    """B = 2, K = 6. Sample 0: two identical boxes (tied heat everywhere
    they cover: both paint, the cell holds their sum), a third box that
    overlaps them, an empty slot, and a box whose center lies outside the
    grid. Sample 1: all slots empty."""
    d = {f: np.zeros(s, t) for f, s, t in (
        ("pos", (2, 6, 3), np.float32), ("dims", (2, 6, 3), np.float32),
        ("rot", (2, 6, 1), np.float32), ("probs", (2, 6, 1), np.float32),
        ("velo", (2, 6, 1), np.float32), ("valid", (2, 6), bool),
        ("class_id", (2, 6, 1), np.int32), ("difficulty", (2, 6, 1), np.int32))}
    d["pos"][0, :5] = [[5.0, 2.0, -1.0], [5.0, 2.0, -1.0], [6.5, 3.0, -0.8],
                       [0.0, 0.0, 0.0], [21.0, -3.0, -1.0]]
    d["dims"][0, :5] = [[4.0, 2.0, 1.5], [4.0, 2.0, 1.5], [3.0, 1.8, 1.4],
                        [4.0, 2.0, 1.5], [4.5, 2.0, 1.6]]
    d["rot"][0, :5, 0] = [0.3, 0.3, -1.1, 0.0, 2.0]
    d["velo"][0, :5, 0] = [1.0, -2.0, 0.5, 0.0, 3.0]
    d["probs"][0, :5, 0] = 1.0
    d["valid"][0] = [True, True, True, False, True, False]
    return d


@pytest.mark.parametrize("grid_hw", [(16, 16), (20, 12)])
def test_render_centermaps(grid_hw):
    jb, tb = both(_scene_boxes())
    for dims_method in ("predict_abs_size", "predict_log_size"):
        jcfg = JCfg(dimensions_method=dims_method)
        tcfg = BoxPredictionCfg(dimensions_method=dims_method)
        want = jcm.render_centermaps(jb, JBev(*BEV), grid_hw, jcfg)
        got = tcm.render_centermaps(tb, BevSetup(*BEV), grid_hw, tcfg)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
    m = got["center_bool_mask"].numpy()
    assert m[0].sum() == 2 and m[1].sum() == 0  # the far center is dropped
    # where the two identical boxes are the hottest, both paint: their
    # velocities 1 and -2 sum to -1
    assert np.isclose(got["velo"][0].numpy(), -1.0).sum() > 0


@pytest.mark.parametrize("with_ignore", [False, True])
def test_losses(with_ignore):
    """focal_heatmap_loss and centerpoint_loss on random predictions
    against the rendered targets of the scene boxes; relative 1e-5 (fp32
    sums over 2 x 16 x 16 cells in another order)."""
    rng = np.random.RandomState(1 + with_ignore)
    jb, tb = both(_scene_boxes())
    gt_j = jcm.render_centermaps(jb, JBev(*BEV), (16, 16), JCfg())
    gt_t = tcm.render_centermaps(tb, BevSetup(*BEV), (16, 16), BoxPredictionCfg())
    act = {"probs": rng.randn(2, 16, 16, 1), "rot": rng.randn(2, 16, 16, 2),
           "dims": rng.rand(2, 16, 16, 3) * 4, "pos": rng.randn(2, 16, 16, 3)}
    dec = {"dims": np.abs(act["dims"]) + 0.5, "pos": act["pos"] * 10,
           "rot": act["rot"][..., :1], "probs": act["probs"]}
    act = {k: v.astype(np.float32) for k, v in act.items()}
    dec = {k: v.astype(np.float32) for k, v in dec.items()}
    ign = rng.rand(2, 16, 16) < 0.2 if with_ignore else None
    jign = None if ign is None else jnp.asarray(ign)
    tign = None if ign is None else _t(ign)

    want = jloss.focal_heatmap_loss(jnp.asarray(act["probs"]), gt_j["probs"],
                                    gt_j["center_bool_mask"], jign)
    got = tloss.focal_heatmap_loss(_t(act["probs"]), gt_t["probs"],
                                   gt_t["center_bool_mask"], tign)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)

    want = jloss.centerpoint_loss(
        decoded_pred_maps={k: jnp.asarray(v) for k, v in dec.items()},
        raw_activated_maps={k: jnp.asarray(v) for k, v in act.items()},
        gt_maps=gt_j, center_mask=gt_j["center_bool_mask"], ignore_mask=jign)
    got = tloss.centerpoint_loss(
        decoded_pred_maps={k: _t(v) for k, v in dec.items()},
        raw_activated_maps={k: _t(v) for k, v in act.items()},
        gt_maps=gt_t, center_mask=gt_t["center_bool_mask"], ignore_mask=tign)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def _pairs():
    """(a, b) box pairs as (pos, dims, rot) rows: identical, contained,
    edge-touching, disjoint, rotated overlaps, corner-only overlap, a box
    rotated by 90 degrees onto itself, and z-offset (3D only differs)."""
    a = [([0, 0, 0], [4, 2, 1.5], 0.0), ([0, 0, 0], [4, 2, 1.5], 0.0),
         ([0, 0, 0], [4, 2, 1.5], 0.0), ([0, 0, 0], [4, 2, 1.5], 0.0),
         ([1, 2, 0], [4, 2, 1.5], 0.4), ([0, 0, 0], [2, 2, 2], 0.0),
         ([3, -1, 0], [4, 4, 1], 0.0), ([0, 0, 0], [4, 2, 1.5], 0.0)]
    b = [([0, 0, 0], [4, 2, 1.5], 0.0), ([0.5, 0.2, 0], [2, 1, 1], 0.3),
         ([4, 0, 0], [4, 2, 1.5], 0.0), ([10, 10, 0], [4, 2, 1.5], 1.0),
         ([1.5, 1.8, 0.3], [3, 2.5, 1.2], -0.9), ([2, 2, 0], [2, 2, 2], 0.7),
         ([3, -1, 0], [4, 4, 1], np.pi / 2), ([0.3, 0, 1.0], [4, 2, 1.5], 0.1)]

    def arr(rows):
        pos = np.array([r[0] for r in rows], np.float32)
        dims = np.array([r[1] for r in rows], np.float32)
        rot = np.array([[r[2]] for r in rows], np.float32)
        return pos, dims, rot

    return arr(a), arr(b)


@pytest.mark.parametrize("kind", ["bev", "3d"])
def test_iou_matrices(kind):
    """The full [Ka, Kb] matrix over the listed pairs (and every cross
    pair), then a random [40, 40] with invalid rows and columns: within
    1e-5 (fp32 trigonometry and shoelace sums in another order)."""
    jf = {"bev": jiou.iou_matrix_bev, "3d": jiou.iou_matrix_3d}[kind]
    tf = {"bev": tiou.iou_matrix_bev, "3d": tiou.iou_matrix_3d}[kind]
    (pa, da, ra), (pb, db, rb) = _pairs()
    want = np.asarray(jf(*(jnp.asarray(x) for x in (pa, da, ra, pb, db, rb))))
    got = tf(*(_t(x) for x in (pa, da, ra, pb, db, rb))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    diag = np.diag(got)
    assert np.isclose(diag[0], 1.0, atol=1e-6)  # identical
    assert diag[3] == 0.0  # disjoint
    if kind == "bev":
        assert np.isclose(diag[1], 2.0 / 8.0, atol=1e-5)  # contained
        assert np.isclose(diag[6], 1.0, atol=1e-5)  # square turned 90 deg
    rng = np.random.RandomState(5)
    d = random_boxes(rng, 1, 40, spread=6.0)
    d["pos"][..., 2] *= 0.1  # overlapping z-intervals too
    args = [d["pos"][0], d["dims"][0], d["rot"][0]] * 2
    want = np.asarray(jf(*(jnp.asarray(x) for x in args),
                         jnp.asarray(d["valid"][0]), jnp.asarray(d["valid"][0])))
    got = tf(*(_t(x) for x in args), _t(d["valid"][0]), _t(d["valid"][0])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (want > 0.1).sum() > 40  # the random set overlaps


@pytest.mark.parametrize("bev", [True, False])
def test_nms_boxes(bev):
    """Same kept boxes in the same order, the unfilled slots included,
    over K = 128 crowded random boxes with tied and invalid scores."""
    rng = np.random.RandomState(6 + bev)
    d = random_boxes(rng, 2, 128, spread=8.0)
    d["probs"][:, 10:20] = 0.5  # ties, broken by the lower index
    jb, tb = both(d)
    for post in (100, 30):  # unfilled slots left, and a cut kept set
        want = jnms.batched_nms(jb, 0.1, post, bev=bev)
        got = tnms.batched_nms(tb, 0.1, post, bev=bev)
        assert_boxes(got, want)
    kept = got.valid.sum(1)
    assert bool((kept == 30).all())
    assert int(tnms.batched_nms(tb, 0.1, 100, bev=bev).valid.sum()) < int(
        tb.valid.sum())  # some boxes were suppressed
    one = tnms.nms_boxes(Boxes(**{f: getattr(tb, f)[1] for f in FIELDS}),
                         0.1, 30, bev=bev)
    assert_boxes(one, jnms.nms_boxes(
        JBoxes(**{f: getattr(jb, f)[1] for f in FIELDS}), 0.1, 30, bev=bev))


def test_onecycle():
    """Every step of a short cycle and past its end (clamped), and the
    full-width cycle's phase boundary and end, fp32 on both sides. Within
    2e-6 relative: the two cosines may differ by an fp32 ulp, and on the
    rising phase max_lr + (max_lr / 10 - max_lr) (1 + cos) / 2 cancels to
    a tenth of max_lr, which magnifies that ulp tenfold."""
    for max_lr, total in ((1e-3, 60_002), (3e-3, 250), (1e-4, 10)):
        sj, st = j_onecycle(max_lr, total), onecycle(max_lr, total)
        steps = list(range(0, min(total, 300))) + [
            total // 2, int(0.4 * total) - 2, int(0.4 * total) - 1,
            int(0.4 * total), total - 1, total, total + 5, 3 * total]
        for s in steps:
            np.testing.assert_allclose(float(st(s)), float(sj(s)), rtol=2e-6,
                                       atol=0, err_msg=str((max_lr, total, s)))
        assert float(st(3 * total)) == pytest.approx(max_lr / 100, rel=1e-6)


def test_batchnorm_train_mode():
    """flax BatchNorm(momentum 0.99, eps 1e-3, use_fast_variance=False) in
    train mode on NHWC vs the port's on NCHW: outputs of three batches and
    the running statistics after the three updates, 1e-5 relative; then
    eval mode with the moved statistics. The batches carry a large mean
    (|mean| >> std), where a one-pass variance would cancel."""
    rng = np.random.RandomState(7)
    c = 6
    scale = (1 + 0.2 * rng.randn(c)).astype(np.float32)
    bias = (0.2 * rng.randn(c)).astype(np.float32)
    jm = fnn.BatchNorm(epsilon=1e-3, momentum=0.99, use_fast_variance=False)
    xs = [(50.0 + rng.randn(2, 5, 7, c)).astype(np.float32) for _ in range(3)]
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(0.2 * rng.randn(c), jnp.float32),
                         "var": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)}}
    tm = BatchNorm(c, 1e-3)
    with torch.no_grad():
        tm.weight.copy_(_t(scale))
        tm.bias.copy_(_t(bias))
        tm.running_mean.copy_(_t(v["batch_stats"]["mean"]))
        tm.running_var.copy_(_t(v["batch_stats"]["var"]))
    tm.train()
    for x in xs:
        want, mut = jm.apply(v, jnp.asarray(x), use_running_average=False,
                             mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        got = tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.running_mean.numpy(),
                               np.asarray(v["batch_stats"]["mean"]), rtol=1e-5)
    np.testing.assert_allclose(tm.running_var.numpy(),
                               np.asarray(v["batch_stats"]["var"]), rtol=1e-5)
    tm.eval()
    want = jm.apply(v, jnp.asarray(xs[0]), use_running_average=True)
    got = tm(_t(xs[0]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


def test_adamw_matches_optax():
    """adamw_update_ under the OneCycle schedule against optax.adamw over
    25 steps of gradients spanning seven decades, the learning rate at each
    update taken at the optimizer's count before it: parameters and both
    moments within 1e-6 relative."""
    sched_j, sched_t = j_onecycle(1e-3, 40), onecycle(1e-3, 40)
    rng = np.random.RandomState(8)
    params = {"a": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(7).astype(np.float32)}
    tx = optax.adamw(sched_j, weight_decay=0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: _t(v) for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in tp.items()}
    nu = {k: torch.zeros_like(v) for k, v in tp.items()}
    for count in range(25):
        grads = {k: (rng.randn(*v.shape) * 10.0 ** rng.uniform(-6, 1)).astype(np.float32)
                 for k, v in params.items()}
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, upd)
        adamw_update_(list(tp.values()), [_t(grads[k]) for k in tp],
                      list(mu.values()), list(nu.values()), count,
                      float(sched_t(count)), 0.01)
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(mu[k].numpy(), np.asarray(state[0].mu[k]),
                                       rtol=1e-6)
            np.testing.assert_allclose(nu[k].numpy(), np.asarray(state[0].nu[k]),
                                       rtol=1e-6)
    assert int(state[0].count) == int(state[2].count) == 25
