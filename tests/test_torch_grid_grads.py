"""The plain versions of kernels K4 (grid_gather), K3
(grid_reduce_add_c1) and K1-add (grid_reduce_add), of the fused
scatter-max VJP (scatter_max_vjp) and the grid_gather VJP built on K1-add
(liso_tpu_torch/ops/grid_scatter.py), against liso_tpu's Pallas kernels in
interpret mode (liso_tpu/ops/grid_scatter_pallas.py). The CUDA kernels are
held to these plain versions on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.ops import grid_scatter_pallas as jgs
from liso_tpu_torch.ops import grid_scatter as tgs
from torch_grid_layouts import LAYOUTS, cell_layout

torch.set_num_threads(1)
IMAX = np.iinfo(np.int32).max


def _sorted_cells(rng, b, n, nc, drop_frac=0.1):
    cells = np.sort(rng.randint(0, nc, (b, n)).astype(np.int32), -1)
    drop = rng.rand(b, n) < drop_frac
    cells[drop] = nc  # the drop bucket, id num_cells ...
    cells[:, -3:] = IMAX  # ... and the int32-max pad
    return np.sort(cells, -1)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("nc,c", [(1000, 8), (4096, 64), (1000, 2), (1000, 3)])
def test_grid_gather_matches_pallas(nc, c):
    """Bitwise: a gather moves values, at any C (C = 2 is the decoder's
    flow gather). Drop-bucket ids read 0."""
    rng = np.random.RandomState(nc + c)
    cells = _sorted_cells(rng, 2, 1024, nc)
    grid = rng.randn(2, nc, c).astype(np.float32)
    want = jgs._grid_gather_impl(jnp.asarray(grid), jnp.asarray(cells),
                                 interpret=True)
    got = tgs.grid_gather(_t(grid), _t(cells))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got[_t(cells) >= nc] == 0).all())


@pytest.mark.parametrize("c", [2, 64])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_grid_gather_matches_pallas_edge_layouts(layout, c):
    """The port's grid_gather (the plain version K4 is held to on the card)
    vs _grid_gather_impl(interpret=True) on the edge layouts of
    tests/torch_grid_layouts.py, at the decoder's C = 2 and at C = 64:
    bitwise, drop-bucket ids (num_cells and int32 max) read 0."""
    b, n, nc = 2, 1000, 2000
    rng = np.random.RandomState(c + len(layout))
    cells = cell_layout(layout, rng, b, n, nc)
    grid = rng.randn(b, nc, c).astype(np.float32)
    want = jgs._grid_gather_impl(jnp.asarray(grid), jnp.asarray(cells),
                                 interpret=True)
    got = tgs.grid_gather(_t(grid), _t(cells))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got[_t(cells) >= nc] == 0).all())


def test_grid_gather_without_gradient_skips_autograd():
    """A gather of a grid that needs no gradient (or under no_grad) returns
    a tensor with no grad_fn; with a gradient it still refuses unsorted
    ids and records its backward."""
    rng = np.random.RandomState(13)
    cells = _t(_crowded_cells(rng, 2, 256, 100))
    grid = torch.randn(2, 100, 2)
    assert tgs.grid_gather(grid, cells).grad_fn is None
    with torch.no_grad():
        assert tgs.grid_gather(grid.requires_grad_(), cells).grad_fn is None
    assert tgs.grid_gather(grid, cells).grad_fn is not None
    with pytest.raises(ValueError, match="ascending"):
        tgs.grid_gather(grid, cells.flip(-1))


@pytest.mark.parametrize("ties", [False, True])
def test_scatter_max_vjp_matches_pallas_vjp(ties):
    """The port's autograd of grid_scatter_max_occ vs jax.vjp of
    grid_reduce_with_occ(..., "max", interpret=True): the TPU VJP, where
    every tied maximum gets the full cotangent. With `ties`, features are
    rounded to a coarse lattice so that many points of a cell share its
    maximum (JAX's CPU segment_max would split the cotangent there)."""
    rng = np.random.RandomState(3 + ties)
    b, n, nc, c = 2, 1024, 256, 16
    cells = _sorted_cells(rng, b, n, nc)
    feats = rng.randn(b, n, c).astype(np.float32)
    if ties:
        feats = np.round(feats)
    g = rng.randn(b, nc, c).astype(np.float32)
    (want_grid, want_occ), vjp = jax.vjp(
        lambda f: jgs.grid_reduce_with_occ(f, jnp.asarray(cells), nc, "max",
                                           True),
        jnp.asarray(feats),
    )
    (want_df,) = vjp((jnp.asarray(g), jnp.zeros_like(want_occ)))
    tf = _t(feats).requires_grad_()
    grid, occ = tgs.grid_scatter_max_occ(tf, _t(cells), nc)
    (grid * _t(g)).sum().backward()
    np.testing.assert_array_equal(grid.detach().numpy(), np.asarray(want_grid))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))
    np.testing.assert_array_equal(tf.grad.numpy(), np.asarray(want_df))
    if ties:  # the data really has ties that take the full cotangent
        winners = (tf.grad != 0).sum()
        assert int(winners) > int((grid != 0).sum()) + 100


def _bits(x):
    """Bit patterns, so that -0.0 and +0.0 (and NaN payloads) differ."""
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", ["no_ties", "ties", "dropped",
                                  "signed_zeros_nan"])
def test_scatter_max_vjp_plain_matches_pallas_vjp(case, dtype):
    """scatter_max_vjp_plain, the oracle of the fused CUDA VJP, is bitwise
    the Pallas VJP of grid_reduce_with_occ(..., "max", interpret=True):
    every tied maximum gets the full cotangent; drop-bucket points (ids
    num_cells .. num_cells + 23, inside the Pallas grid's pad rows, and the
    int32-max pad) get +0.0, even where their feature is 0. In
    `signed_zeros_nan` the features hold -0.0, +0.0 and NaN: -0.0 ties
    with +0.0 and NaN never wins. There the VJP rule itself is called with
    a finite grid (a NaN or inf in a grid tile would reach every point of
    the tile through the TPU's one-hot matmul gather)."""
    rng = np.random.RandomState(["no_ties", "ties", "dropped",
                                 "signed_zeros_nan"].index(case))
    b, n, nc, c = 2, 1024, 1000, 16
    cells = _crowded_cells(rng, b, n, nc)
    if case == "dropped":  # half the points in the drop bucket
        cells = np.sort(np.where(rng.rand(b, n) < 0.5, nc + rng.randint(
            0, 24, (b, n)), cells).astype(np.int32), -1)
    feats = rng.randn(b, n, c).astype(np.float32)
    if case in ("ties", "dropped"):
        feats = np.round(feats)
    if case == "signed_zeros_nan":
        feats = -np.abs(np.round(feats * 0.8))  # many -0.0
        zero = feats == 0
        feats[zero & (rng.rand(*feats.shape) < 0.5)] = 0.0  # and +0.0
        feats[rng.rand(*feats.shape) < 0.05] = np.nan
    g = rng.randn(b, nc, c).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    # the same values on both sides (bf16 values pass through fp32 exactly)
    tf, tg = _t(feats).to(tdt), _t(g).to(tdt)
    jf, jg = jnp.asarray(tf.float().numpy(), jdt), jnp.asarray(tg.float().numpy(), jdt)
    jc = jnp.asarray(cells)
    if case != "signed_zeros_nan":
        (want_grid, want_occ), vjp = jax.vjp(
            lambda f: jgs.grid_reduce_with_occ(f, jc, nc, "max", True), jf)
        (want,) = vjp((jg, jnp.zeros_like(want_occ)))
        grid = tgs.grid_scatter_max_occ(tf, _t(cells), nc)[0]
        np.testing.assert_array_equal(
            grid.float().numpy(), np.asarray(want_grid.astype(jnp.float32)))
    else:
        grid = tgs.grid_scatter_max_occ(torch.nan_to_num(tf, nan=-7.0),
                                        _t(cells), nc)[0]
        want, _ = jgs._grid_reduce_occ_bwd(
            nc, "max", True, True,
            (jc, jf, jnp.asarray(grid.float().numpy(), jdt)),
            (jg, jnp.zeros((b, nc, 1), jnp.float32)))
    got = tgs.scatter_max_vjp_plain(tf, _t(cells), grid, tg)
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(_bits(got.float().numpy()), _bits(want))
    win = got != 0
    assert int(win.sum()) > 100
    if case == "ties":  # many points share their cell's maximum
        assert int(win.sum()) > int((grid != 0).sum()) + 100
    if case == "dropped":
        dropped = _t(cells) >= nc
        assert int(dropped.sum()) > n // 2
        assert bool((got[dropped] == 0).all()) and bool((tf[dropped] == 0).any())
    if case == "signed_zeros_nan":  # both zeros win, NaN never does
        neg0 = (tf == 0) & torch.signbit(tf)
        assert bool(win[neg0].any()) and bool(win[(tf == 0) & ~neg0].any())
        assert bool((got[torch.isnan(tf)] == 0).all())


@pytest.mark.parametrize("rows,n,res", [(2, 4096, 2048), (3, 2048, 100_000)])
def test_grid_reduce_add_c1_matches_pallas(rows, n, res):
    """K3's plain version vs grid_reduce(..., "add", interpret=True) with
    C = 1 (the scalar-channel kernel): per-bin fp32 sums in other orders,
    within n * 2^-24 * sum |v| of each bin, twice. The second case is the
    threshold histogram's own bin count (padded to a multiple of 2048)."""
    rng = np.random.RandomState(rows)
    res_pad = -(-res // 2048) * 2048
    bins = np.sort(rng.randint(0, res + res // 8, (rows, n)).astype(np.int32), -1)
    bins[:, :50] = 7  # a crowded bin
    bins = np.sort(bins, -1)
    bins[bins >= res] = IMAX
    if rows == 3:
        bins[2] = IMAX  # an all-dropped row
    vals = rng.randn(rows, n).astype(np.float32)
    want = np.asarray(jgs.grid_reduce(
        jnp.asarray(vals[..., None]), jnp.asarray(bins), res_pad, "add", True
    ))[..., 0]
    got = tgs.grid_reduce_add_c1(_t(vals), _t(bins), res_pad).numpy()
    assert got.shape == want.shape == (rows, res_pad)
    absum = tgs.grid_reduce_add_c1(_t(np.abs(vals)), _t(bins), res_pad).numpy()
    cnt = tgs.grid_reduce_add_c1(_t(np.ones_like(vals)), _t(bins), res_pad).numpy()
    assert (np.abs(got - want) <= 2 * cnt * 2.0**-24 * absum).all()
    assert (got[:, res:] == 0).all()
    if rows == 3:
        assert (got[2] == 0).all()


@pytest.mark.parametrize("layout,rows", [
    ("one_cell", 2), ("end_cells", 2), ("all_dropped", 3), ("uniform", 1),
    ("skewed", 2), ("crowded", 2)])
def test_grid_reduce_add_c1_matches_pallas_edge_layouts(layout, rows):
    """K3's plain version vs the Pallas C = 1 kernel (interpret mode) on the
    edge layouts the card tests hold the CUDA kernel to
    (tests/torch_grid_layouts.py): every value in one bin, bins 0 and
    num_bins - 1, an all-dropped row, one row, every value in 8 bins, bins
    crowded near the middle. Within the fp32 sum-order bound; empty bins
    exactly 0."""
    n, nb = 2048, 4096
    rng = np.random.RandomState(rows + len(layout))
    bins = cell_layout(layout, rng, rows, n, nb)
    vals = rng.randn(rows, n).astype(np.float32)
    want = np.asarray(jgs.grid_reduce(
        jnp.asarray(vals[..., None]), jnp.asarray(bins), nb, "add", True
    ))[..., 0]
    got = tgs.grid_reduce_add_c1(_t(vals), _t(bins), nb).numpy()
    absum = tgs.grid_reduce_add_c1(_t(np.abs(vals)), _t(bins), nb).numpy()
    cnt = tgs.grid_reduce_add_c1(_t(np.ones_like(vals)), _t(bins), nb).numpy()
    assert (np.abs(got - want) <= 2 * cnt * 2.0**-24 * absum).all()
    assert (got[cnt == 0] == 0).all() and (want[cnt == 0] == 0).all()
    if layout == "end_cells":
        assert (cnt[:, 0] > 0).all() and (cnt[:, -1] > 0).all()
    if layout == "all_dropped":
        assert cnt[-1].sum() == 0


def _crowded_cells(rng, b, n, nc):
    """Ascending ids with half of the points in 40 cells (so cells sum
    many rows), drop-bucket ids nc .. nc + 23 (inside the Pallas grid's
    pad rows: 1000 cells pad to a 1024-cell tile) and the int32-max pad."""
    cells = np.where(rng.rand(b, n) < 0.5, rng.randint(0, 40, (b, n)),
                     rng.randint(0, nc + 24, (b, n))).astype(np.int32)
    cells[:, -5:] = IMAX
    return np.sort(cells, -1)


@pytest.mark.parametrize("c", [2, 8, 64])
def test_grid_reduce_add_matches_pallas(c):
    """K1-add's plain version vs _grid_reduce_impl(..., "add",
    interpret=True) at C > 1, fp32, 1000 cells (not a multiple of the
    Pallas tile): per-cell sums in other orders, within the fp32
    sum-order bound 2 n 2^-24 sum |v| of each cell. Empty and dropped
    cells read exactly 0."""
    rng = np.random.RandomState(c)
    b, n, nc = 2, 1024, 1000
    cells = _crowded_cells(rng, b, n, nc)
    g = rng.randn(b, n, c).astype(np.float32)
    want = np.asarray(jgs._grid_reduce_impl(
        jnp.asarray(g), jnp.asarray(cells), nc, "add", interpret=True))
    got = tgs.grid_reduce_add(_t(g), _t(cells), nc).numpy()
    assert got.shape == want.shape == (b, nc, c)
    absum = tgs.grid_reduce_add(_t(np.abs(g)), _t(cells), nc).numpy()
    cnt = tgs.grid_reduce_add(_t(np.ones_like(g)), _t(cells), nc).numpy()
    assert (np.abs(got - want) <= 2 * cnt * 2.0**-24 * absum).all()
    assert cnt.max() > 10 and (got[cnt == 0] == 0).all()
    assert (want[cnt == 0] == 0).all()


def test_grid_gather_vjp_matches_pallas_vjp():
    """The port's grid_gather autograd (backward: grid_reduce_add) vs
    jax.vjp of grid_gather(..., interpret=True), whose VJP is
    _grid_reduce_impl(..., "add"): forward bitwise, grid cotangent within
    1e-5 of its norm (fp32 sums in other orders)."""
    rng = np.random.RandomState(11)
    b, n, nc, c = 2, 1024, 1000, 16
    cells = _crowded_cells(rng, b, n, nc)
    grid = rng.randn(b, nc, c).astype(np.float32)
    ct = rng.randn(b, n, c).astype(np.float32)
    want, vjp = jax.vjp(
        lambda x: jgs.grid_gather(x, jnp.asarray(cells), True), jnp.asarray(grid))
    (want_dg,) = vjp(jnp.asarray(ct))
    tg = _t(grid).requires_grad_()
    got = tgs.grid_gather(tg, _t(cells))
    (got * _t(ct)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    err = np.linalg.norm(tg.grad.numpy() - np.asarray(want_dg))
    assert err <= 1e-5 * np.linalg.norm(np.asarray(want_dg)), err
    assert (tg.grad.numpy() != 0).sum(-1).astype(bool).sum() > 500


def test_grid_gather_with_gradient_needs_ascending_cells():
    """The backward sums each cell's rows as one range, so a differentiable
    gather refuses unsorted ids; a gather without gradient takes them."""
    rng = np.random.RandomState(12)
    cells = _t(rng.permutation(_crowded_cells(rng, 2, 256, 100)[0])[None])
    grid = torch.randn(1, 100, 8)
    want = tgs.grid_gather_plain(grid, cells)
    assert torch.equal(tgs.grid_gather(grid, cells), want)
    with torch.no_grad():
        assert torch.equal(tgs.grid_gather(grid.requires_grad_(), cells), want)
    with pytest.raises(ValueError, match="ascending"):
        tgs.grid_gather(grid, cells)
    tgs.grid_gather(grid, torch.sort(cells, -1).values).sum().backward()
