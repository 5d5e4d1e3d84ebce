"""Kernel K6's plain version and its band (liso_tpu_torch/ops/knn.py,
liso_tpu_torch/ops/knn_banded.py) against liso_tpu: the exact brute force
`nn_1` against JAX's `nn_1`, the banded search against the Pallas kernel
`nn_1_sorted` in interpret mode (`nn_1_sorted_band_plain`, the exact
search over the band of the port's `band_ranges`: the function the CUDA
kernel computes, and its oracle on the card),
and the fixed-neighbour gradient against JAX's gradient through `nn_1` (the
JAX CPU path of the SLIM loss). The CUDA kernel is held to its plain
version on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.ops.knn import nn_1 as j_nn_1
from liso_tpu.ops.knn_pallas import nn_1_sorted as j_nn_1_sorted
from liso_tpu_torch.ops import knn_banded as kb
from liso_tpu_torch.ops.knn import BIG, nn_1

torch.set_num_threads(1)


def _clouds(b=2, nq=1536, nr=3072, r_valid_frac=0.7, seed=1):
    """x-sorted clouds with their invalid points at the tail (how the cell
    sort orders them), so the last ref tile is empty; queries are refs
    moved by about 0.5 m."""
    rng = np.random.RandomState(seed)

    def cloud(n, n_valid, lo=-40, hi=40):
        pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
        pts[:n_valid] = pts[:n_valid][np.argsort(pts[:n_valid, 0])]
        valid = np.zeros(n, bool)
        valid[:n_valid] = True
        return pts, valid

    rs = [cloud(nr, int(nr * r_valid_frac)) for _ in range(b)]
    r = np.stack([p for p, _ in rs])
    rv = np.stack([v for _, v in rs])
    q = r[:, rng.randint(0, int(nr * r_valid_frac), nq)].copy()
    q = q[np.arange(b)[:, None], np.argsort(q[..., 0], -1)]
    q += rng.normal(0, 0.5, q.shape).astype(np.float32)
    qv = rng.rand(b, nq) > 0.05
    return q, qv, r, rv


def _t(x):
    return torch.from_numpy(np.array(x))


def test_nn_1_matches_jax():
    q, qv, r, rv = _clouds(b=1)
    want_d, want_i = j_nn_1(jnp.asarray(q[0]), jnp.asarray(r[0]),
                            jnp.asarray(qv[0]), jnp.asarray(rv[0]), chunk=512)
    got_d, got_i = nn_1(_t(q[0]), _t(r[0]), _t(qv[0]), _t(rv[0]), chunk=512)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5,
                               atol=1e-3)
    assert (got_d.numpy()[~qv[0]] == BIG).all()
    assert (got_i.numpy()[~qv[0]] == 0).all()


def test_band_matches_pallas_kernel():
    """Every query, in band or not: the Pallas kernel and the port's band
    visit the same tiles, so distances agree to the fp32 metric's rounding
    and indices wherever the two best refs are not a near-tie."""
    q, qv, r, rv = _clouds()
    q[:, -512:, 0] += 100.0  # the last chunk of queries lies past the
    # refs in x by more than the band: no tile is visited, d = BIG
    want_d, want_i = map(np.asarray, j_nn_1_sorted(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(qv), jnp.asarray(rv),
        interpret=True))
    got_d, got_i = kb.nn_1_sorted_band_plain(_t(q), _t(r), _t(qv), _t(rv), 8.0)
    got_d, got_i = got_d.numpy(), got_i.numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=2e-3)
    assert (got_i == want_i).mean() > 0.999
    exact_d, exact_i = kb.nn_1_sorted(_t(q), _t(r), _t(qv), _t(rv))
    # the report that holds the CUDA kernel to its contract on the card
    rep = kb.contract_report(_t(q), _t(r), _t(qv), _t(rv), 8.0, _t(got_d),
                             _t(got_i), exact_d, exact_i)
    assert rep["below_exact"] == 0 and rep["in_band_mismatch"] == 0, rep
    assert rep["in_band"] > 0.6 * rep["valid"], rep
    cut = want_d > exact_d.numpy() + 1e-2
    assert cut[qv].sum() > 400  # the band really cut these searches short
    assert (want_d[:, -512:][qv[:, -512:]] == BIG).all()


def test_plain_matches_pallas_within_margin():
    """The plain version (exact) equals the banded kernel's result wherever
    the exact neighbour lies within the 8 m band, as
    tests/test_ops_grid.py:310 holds the Pallas kernel to the brute force."""
    q, qv, r, rv = _clouds(seed=2)
    want_d, want_i = map(np.asarray, j_nn_1_sorted(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(qv), jnp.asarray(rv),
        interpret=True))
    got_d, got_i = (x.numpy() for x in kb.nn_1_sorted(_t(q), _t(r), _t(qv),
                                                       _t(rv)))
    nn_x = r[np.arange(2)[:, None], got_i, 0]
    close = qv & (np.abs(q[..., 0] - nn_x) < 8.0)
    assert close.sum() > 0.9 * qv.sum()
    np.testing.assert_array_equal(got_i[close], want_i[close])
    np.testing.assert_allclose(got_d[close], want_d[close], rtol=1e-5, atol=1e-3)
    assert (got_d >= want_d * (1 - 1e-5) - 1e-3)[qv].all()  # the band only
    # removes refs


def test_fixed_neighbour_gradient_matches_jax_cpu_path():
    """d(sum(w * d)) / dq of nn_1_sorted_diff vs JAX's gradient through
    nn_1 (what the JAX train step differentiates on the CPU)."""
    q, qv, r, rv = _clouds(b=2, nq=512, nr=1024, seed=3)
    w = np.random.RandomState(4).rand(*qv.shape).astype(np.float32)

    def jloss(qq):
        d = jax.vmap(lambda a, b_, av, bv: j_nn_1(a, b_, av, bv, chunk=256)[0])(
            qq, jnp.asarray(r), jnp.asarray(qv), jnp.asarray(rv))
        return jnp.sum(jnp.where(jnp.asarray(qv), d, 0.0) * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(q)))
    tq = _t(q).requires_grad_()
    d = kb.nn_1_sorted_diff(tq, _t(r), _t(qv), _t(rv))
    (torch.where(_t(qv), d, 0.0) * _t(w)).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), want, rtol=1e-4, atol=1e-4)


def test_band_plain_equals_exact_search_when_the_band_covers_all():
    """With a margin wider than the clouds every chunk's band holds every
    valid ref, so the band oracle is the exact search (up to fp32
    near-ties between the chunked and the whole-cloud sums)."""
    q, qv, r, rv = _clouds(b=2, nq=1024, nr=2048, seed=5)
    got_d, got_i = kb.nn_1_sorted_band_plain(_t(q), _t(r), _t(qv), _t(rv),
                                             margin=1e4)
    want_d, want_i = kb.nn_1_sorted_plain(_t(q), _t(r), _t(qv), _t(rv))
    rep = kb.contract_report(_t(q), _t(r), _t(qv), _t(rv), float("inf"),
                             got_d, got_i, want_d, want_i)
    assert rep["below_exact"] == 0 and rep["in_band_mismatch"] == 0, rep
    assert (got_i.numpy() == want_i.numpy()).mean() > 0.999
    assert (got_d.numpy()[~qv] == BIG).all() and (got_i.numpy()[~qv] == 0).all()


@pytest.mark.parametrize("margin", [2.0, 8.0])
def test_needed_pairs_counts_the_band_within_the_stop_radius(margin):
    """K6's bound counts, per valid query, the valid refs of its band whose
    x lies within the kernel's stop radius at the exact answer: the same
    count taken pair by pair here."""
    q, qv, r, rv = _clouds(b=2, nq=1200, nr=2500, seed=3)
    tq, tr, tqv, trv = _t(q), _t(r), _t(qv), _t(rv)
    d, _ = kb.nn_1_sorted_band_plain(tq, tr, tqv, trv, margin)
    got = kb.needed_pairs(tq, tr, tqv, trv, d, margin)
    ranges = kb.band_ranges(tq, torch.where(tqv, 0.0, BIG), tr,
                            torch.where(trv, 0.0, BIG), margin).numpy()
    rad = kb.stop_radius(tq, d).numpy()
    want = 0
    for bi in range(q.shape[0]):
        for i in np.flatnonzero(qv[bi]):
            lo, hi = ranges[bi, i // 512]
            ref = slice(lo * 1024, min(hi * 1024, r.shape[1]))
            dx = np.abs(r[bi, ref, 0].astype(np.float64) - float(q[bi, i, 0]))
            want += int((rv[bi, ref] & (dx <= rad[bi, i])).sum())
    assert got == want
    # the exact neighbour lies within the radius: it is always counted
    assert 0 < got < int(qv.sum()) * int(rv.sum(-1).max())


@pytest.mark.parametrize("layout", ["sorted", "shuffled", "sparse_valid"])
def test_sub_tile_bounds(layout):
    """The kernel's stop bounds: per 32-ref sub-tile, the suffix minimum of
    the valid refs' x from that sub-tile on and the prefix maximum up to
    it (+inf / -inf where no valid ref lies there), padding invalid."""
    rng = np.random.RandomState(7)
    b, nr = 2, 2000
    x = np.sort(rng.uniform(-50, 50, (b, nr)).astype(np.float32), -1)
    if layout == "shuffled":  # x not monotone within each 40-ref run
        x = x.reshape(b, -1, 40)[..., rng.permutation(40)].reshape(b, nr)
    valid = rng.rand(b, nr) > (0.9 if layout == "sparse_valid" else 0.1)
    nr_pad = 2048
    suf_min, pre_max = kb.sub_tile_bounds(_t(x), _t(valid), nr_pad)
    assert suf_min.shape == pre_max.shape == (b, nr_pad // 32)
    xv = np.full((b, nr_pad), np.nan, np.float32)
    xv[:, :nr] = np.where(valid, x, np.nan)
    for bi in range(b):
        for s in range(nr_pad // 32):
            after, before = xv[bi, s * 32:], xv[bi, :(s + 1) * 32]
            lo = np.nanmin(after) if np.isfinite(after).any() else np.inf
            hi = np.nanmax(before) if np.isfinite(before).any() else -np.inf
            assert suf_min[bi, s].item() == lo and pre_max[bi, s].item() == hi
