"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: these tests need an NVIDIA GPU with the CUDA toolkit (nvcc)
and skip elsewhere. Run them on a GPU machine with
    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
K1 and K3 are also held on the edge layouts of tests/torch_grid_layouts.py
(one cell holding every point, a run across a tile edge, the first and last
cells, an all-dropped sample, N below the tile, 8-byte rows).
"""
import numpy as np
import pytest
import torch

from liso_tpu_torch import kernels, serve
from liso_tpu_torch.ops import corr_fused, grid_scatter, knn_banded
from liso_tpu_torch.ops.bev import BevSetup
from torch_grid_layouts import LAYOUTS, cell_layout

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize(
    "b,n,nc,c,dtype,layout",
    [
        (2, 4096, 128 * 128, 128, torch.bfloat16, None),
        (2, 4096, 1000, 64, torch.float32, None),
        (3, 2048, 64, 16, torch.bfloat16, None),  # many points per cell, ties
        # edge layouts (tests/torch_grid_layouts.py); the kernel's tile is
        # 1024 cells, and a cell of more than 32 points is taken by the
        # whole block
        (2, 32768, 4096, 64, torch.float32, "one_cell"),
        (2, 4096, 5000, 128, torch.bfloat16, "tile_edge"),
        (2, 4096, 3000, 12, torch.bfloat16, "uniform"),  # 24-byte rows
        (2, 4096, 3000, 12, torch.float32, "uniform"),  # 3 vectors a row
        (3, 2048, 2048, 4, torch.bfloat16, "all_dropped"),  # 8-byte rows
        (2, 2048, 2500, 4, torch.float32, "end_cells"),
        (1, 100, 128 * 128, 64, torch.bfloat16, "uniform"),  # N < tile
        (2, 8192, 846400, 64, torch.bfloat16, "skewed"),
        # the SLIM experiment's fp32 shape (C = 64 over 846400 cells)
        (1, 65536, 846400, 64, torch.float32, "uniform"),
        # detector-mode mining: predict_step on chunks of 8 frames, fp32
        # C = 64 over 512 x 512 cells
        (8, 65536, 512 * 512, 64, torch.float32, "uniform"),
        # evaluation: predict_step at batch 1 (run_val, validate, eval_cli)
        (1, 65536, 512 * 512, 64, torch.float32, "uniform"),
        # the rounds loop's train step: batch 2 at n_max 65536, fp32 C = 64
        # over 512 x 512 cells
        (2, 65536, 512 * 512, 64, torch.float32, "uniform"),
    ],
)
def test_grid_scatter_max_occ_bitwise(gen, b, n, nc, c, dtype, layout):
    if layout is None:
        cells = torch.randint(0, nc + 8, (b, n), generator=gen, device="cuda")
        cells = torch.sort(cells.int(), dim=-1).values
        cells[cells >= nc] = torch.iinfo(torch.int32).max
        if b > 1:
            cells[-1] = nc  # an all-dropped sample
    else:
        cells = torch.from_numpy(cell_layout(
            layout, np.random.RandomState(n + c), b, n, nc)).cuda()
    feats = torch.randn(b, n, c, generator=gen, device="cuda").to(dtype)
    if c == 16:
        feats = torch.round(feats * 2) / 2
    before = kernels.launches["grid_scatter_max_occ"]
    got = grid_scatter.grid_scatter_max_occ(feats, cells, nc)
    assert kernels.launches["grid_scatter_max_occ"] == before + 1
    want = grid_scatter.grid_scatter_max_occ(feats, cells, nc, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("h,c", [(4, 32), (8, 32), (16, 128), (64, 128)])
def test_corr_window_fwd_within_one_ulp(gen, h, c):
    b = 2
    f0 = torch.randn(b, h * h, c, generator=gen, device="cuda")
    f1cat, lv = corr_fused.pool_f1_levels(
        torch.randn(b, h, h, c, generator=gen, device="cuda"), 4
    )
    coords = torch.rand(b, 2, h * h, generator=gen, device="cuda") * (h + 12) - 6
    coords[:, 0, :3] = -1e5
    got = corr_fused.fused_corr_window(f0, f1cat, coords, lv, 3)
    want = corr_fused.fused_corr_window(f0, f1cat, coords, lv, 3, plain=True)
    torch.cuda.synchronize()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    slack = corr_fused.sum_order_slack(f0, f1cat, coords, lv, 3)
    assert bool(((got - want).abs() <= ulp * 1.0001 + slack).all())
    assert bool((got[:, :, :3] == 0).all())


def _grid_coords(h, w, b=1):
    return torch.stack(torch.meshgrid(
        torch.arange(h, device="cuda"), torch.arange(w, device="cuda"),
        indexing="ij")).float().reshape(1, 2, h * w).repeat(b, 1, 1)


@pytest.mark.parametrize(
    "case,h,c",
    [
        ("sigma_0", 64, 128),  # every tap in its tile's region
        ("sigma_2", 64, 32),
        ("sigma_8", 64, 128),  # many level-0 taps on the warp path
        ("level_edge", 40, 128),  # windows straddle every level's edge
        ("all_far_out", 64, 128),
        ("sigma_2", 115, 128),  # the SLIM grid: ragged edge tiles
        ("sigma_2", 115, 32),
    ],
)
def test_corr_window_fwd_layouts(gen, case, h, c):
    """K2's tile regions: flows of sigma 0, 2 and 8 px, tiles whose windows
    straddle a level's edge, every coord far out, the ragged 115 x 115
    grid, C = 32 and 128. Within one bf16 ulp plus the fp32 sum-order
    slack of the plain version; every out-of-range tap exactly 0."""
    b = 2
    f0 = torch.randn(b, h * h, c, generator=gen, device="cuda")
    f1cat, lv = corr_fused.pool_f1_levels(
        torch.randn(b, h, h, c, generator=gen, device="cuda"), 4)
    base = _grid_coords(h, h, b)
    noise = torch.randn(b, 2, h * h, generator=gen, device="cuda")
    if case == "all_far_out":
        coords = torch.where(noise < 0, -1e5, 3e4)
    elif case == "level_edge":
        coords = base * (h + 10) / h - 5 + 0.5 * noise
    else:
        coords = base + float(case.split("_")[1]) * noise
    before = kernels.launches["corr_window_fwd"]
    got = corr_fused.fused_corr_window(f0, f1cat, coords, lv, 3)
    assert kernels.launches["corr_window_fwd"] == before + 1
    want = corr_fused.fused_corr_window(f0, f1cat, coords, lv, 3, plain=True)
    torch.cuda.synchronize()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    slack = corr_fused.sum_order_slack(f0, f1cat, coords, lv, 3)
    assert bool(((got - want).abs() <= ulp * 1.0001 + slack).all())
    ok = torch.cat([corr_fused._window_cells(coords, lv, 3, lvl)[1]
                    for lvl in range(len(lv.shapes))], dim=-1).transpose(1, 2)
    assert bool((got[~ok] == 0).all())
    if case == "all_far_out":
        assert not bool(ok.any())
    else:
        assert bool(ok.any()) and float(got.abs().max()) > 0


def test_serving_path_kernels_vs_plain(gen):
    """The whole slice at a small size, fp32: kernel path vs plain path."""
    _, slim, det = serve.build_models(grid=64, num_iters=2, device="cuda")
    pts = [torch.rand(2, 2048, 4, generator=gen, device="cuda") * 90 - 45
           for _ in range(2)]
    valid = torch.ones(2, 2048, dtype=torch.bool, device="cuda")
    kernels.reset_launches()
    got = serve.fused_forward(slim, det, pts[0], valid, pts[1], valid)
    # eval BN + ReLU: SLIM's PFN norm per frame, CenterPoint's 21 and its PFN
    assert kernels.launches == {**{k: 0 for k in kernels.launches},
                                "grid_scatter_max_occ": 3, "corr_window_fwd": 2,
                                "bn_relu_eval": 2 + 22}
    want = serve.fused_forward(slim, det, pts[0], valid, pts[1], valid, plain=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-3, rtol=1e-3)


def _sorted_cells(gen, b, n, nc):
    cells = torch.randint(0, nc + nc // 8, (b, n), generator=gen, device="cuda")
    cells = torch.sort(cells.int(), dim=-1).values
    cells[cells >= nc] = torch.iinfo(torch.int32).max
    return cells


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [2, 3, 8, 64])
def test_grid_gather_bitwise(gen, c, dtype):
    """K4 at any C: 16-byte rows (C = 8 bf16, 64), 8-byte (C = 2 fp32), 4-
    and 2-byte (C = 2, 3 bf16), 12-byte (C = 3 fp32)."""
    cells = _sorted_cells(gen, 2, 4096, 5000)
    grid = torch.randn(2, 5000, c, generator=gen, device="cuda").to(dtype)
    before = kernels.launches["grid_gather"]
    got = grid_scatter.grid_gather(grid, cells)
    assert kernels.launches["grid_gather"] == before + 1
    want = grid_scatter.grid_gather(grid, cells, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("c,dtype", [(64, torch.bfloat16), (2, torch.float32),
                                     (3, torch.bfloat16)])
def test_grid_gather_layouts(gen, layout, c, dtype):
    """K4 bitwise on the edge layouts of tests/torch_grid_layouts.py, N not
    a multiple of a warp's 32 points, and on an unaligned view (the
    narrowest vector path)."""
    b, n, nc = 2, 4000, 5000
    cells = torch.from_numpy(cell_layout(
        layout, np.random.RandomState(n + c), b, n, nc)).cuda()
    flat = torch.randn(b * nc * c + 1, generator=gen, device="cuda").to(dtype)
    for g in (flat[:-1], flat[1:]):  # aligned, then one element off
        g = g.view(b, nc, c)
        got = grid_scatter.grid_gather(g, cells)
        want = grid_scatter.grid_gather(g, cells, plain=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_scatter_max_vjp_bitwise(gen):
    """The K1 backward through the fused VJP kernel (one launch, no K4) vs
    the plain VJP, with ties (features on a coarse lattice)."""
    cells = _sorted_cells(gen, 2, 4096, 512)
    feats = torch.round(torch.randn(2, 4096, 16, generator=gen, device="cuda") * 2)
    g = torch.randn(2, 512, 16, generator=gen, device="cuda")
    grads = []
    for plain in (False, True):
        f = feats.clone().requires_grad_()
        grid, _ = grid_scatter.grid_scatter_max_occ(f, cells, 512, plain=plain)
        before = dict(kernels.launches)
        (grid * g).sum().backward()
        assert kernels.launches["scatter_max_vjp"] == (
            before["scatter_max_vjp"] + (0 if plain else 1))
        assert kernels.launches["grid_gather"] == before["grid_gather"]
        grads.append(f.grad)
    torch.cuda.synchronize()
    assert torch.equal(grads[0].view(torch.int32), grads[1].view(torch.int32))


@pytest.mark.parametrize(
    "b,n,nc,c,dtype,in_grid,special",
    [
        # the SLIM step's shape: 5559 of 65536 points reach the grid
        (1, 65536, 846400, 64, torch.bfloat16, 5559, False),
        # the detector's: every point in the grid
        (2, 32768, 512 * 512, 64, torch.float32, 32768, False),
        # the SLIM experiment's fp32 step: 33448 of 65536 points in the grid
        (1, 65536, 846400, 64, torch.float32, 33448, False),
        # the rounds loop's train step: batch 2 at n_max 65536 over 512 x 512
        # cells, about 3500 real points of each padded synthetic frame
        (2, 65536, 512 * 512, 64, torch.float32, 3500, False),
        # 8-byte vectors (rows not a multiple of 16 bytes), -0.0, +0.0, NaN
        (2, 4096, 3000, 4, torch.bfloat16, 3000, True),
        (2, 4096, 3000, 12, torch.bfloat16, 4096, True),
        (2, 4096, 3000, 12, torch.float32, 4096, True),
    ],
)
def test_scatter_max_vjp_kernel_bitwise(gen, b, n, nc, c, dtype, in_grid,
                                        special):
    """The fused VJP kernel vs scatter_max_vjp_plain, as bit patterns:
    features on a coarse lattice (ties), the grid from K1, dropped points
    past the first `in_grid` of each sample; with `special`, features hold
    -0.0, +0.0 and NaN (-0.0 ties with +0.0, NaN never wins)."""
    cells = torch.sort(torch.randint(0, nc, (b, n), generator=gen, device="cuda")
                       .int(), -1).values
    cells[:, in_grid:] = torch.iinfo(torch.int32).max
    cells[:, in_grid:in_grid + 8] = nc  # the first drop-bucket id
    cells = torch.sort(cells, -1).values
    feats = torch.round(2 * torch.randn(b, n, c, generator=gen, device="cuda")) / 2
    if special:
        feats = -feats.abs()  # every 0 is -0.0 ...
        flip = torch.rand(feats.shape, generator=gen, device="cuda") < 0.5
        feats = torch.where((feats == 0) & flip, 0.0, feats)  # ... or +0.0
        nan = torch.rand(feats.shape, generator=gen, device="cuda") < 0.05
        feats = torch.where(nan, torch.nan, feats)
    feats = feats.to(dtype)
    grid = grid_scatter.grid_scatter_max_occ(torch.nan_to_num(feats, nan=-7.0),
                                             cells, nc)[0]
    g = torch.randn(b, nc, c, generator=gen, device="cuda").to(dtype)
    before = kernels.launches["scatter_max_vjp"]
    got = grid_scatter.scatter_max_vjp(feats, cells, grid, g)
    assert kernels.launches["scatter_max_vjp"] == before + 1
    want = grid_scatter.scatter_max_vjp(feats, cells, grid, g, plain=True)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    assert int((got != 0).sum()) > 0
    if special:
        assert bool((got[torch.isnan(feats)] == 0).all())


@pytest.mark.parametrize(
    "r,n,nb,layout",
    [
        (6, 131072, 100352, None),  # the train step's histogram
        # edge layouts (tests/torch_grid_layouts.py); a cluster of 8 blocks
        # owns 16384 bins and splits their values evenly, each block walks
        # its share in chunks of 4096 values, 16 a thread, and a bin's
        # values may cross a thread's, a chunk's and a block's edge
        (6, 131072, 100352, "one_cell"),  # every value in one bin
        (6, 131072, 100352, "skewed"),  # every value in <= 8 bins
        # tens to hundreds of values a bin over a few tiles, as in the
        # SLIM step's histogram
        (6, 131072, 100352, "crowded"),
        (3, 8192, 100352, "end_cells"),  # bins 0 and num_bins - 1
        (3, 8192, 5000, "all_dropped"),  # the last row is all dropped
        (1, 4096, 2048, "uniform"),  # one row
        (2, 30000, 40000, "uniform"),  # three clusters, the last one short
    ],
)
def test_grid_reduce_add_c1_within_sum_order_bound(gen, r, n, nb, layout):
    if layout is None:
        bins = torch.randint(0, 100000, (r, n), generator=gen, device="cuda").int()
        bins[:, :500] = 7
        bins[:, -100:] = torch.iinfo(torch.int32).max
        bins = torch.sort(bins, dim=-1).values
    else:
        bins = torch.from_numpy(cell_layout(
            layout, np.random.RandomState(r + n), r, n, nb)).cuda()
    vals = torch.randn(r, n, generator=gen, device="cuda")
    before = kernels.launches["grid_reduce_add_c1"]
    got = grid_scatter.grid_reduce_add_c1(vals, bins, nb)
    assert kernels.launches["grid_reduce_add_c1"] == before + 1
    want = grid_scatter.grid_reduce_add_c1(vals, bins, nb, plain=True)
    absum = grid_scatter.grid_reduce_add_c1(vals.abs(), bins, nb, plain=True)
    cnt = grid_scatter.grid_reduce_add_c1(torch.ones_like(vals), bins, nb, plain=True)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 2 * cnt * 2.0**-24 * absum).all())
    assert bool((got[cnt == 0] == 0).all())


@pytest.mark.parametrize("h,c", [(8, 32), (16, 128), (115, 128)])
def test_corr_window_bwd_within_sum_order_slack(gen, h, c):
    b = 1 if h > 64 else 2
    f0 = torch.randn(b, h * h, c, generator=gen, device="cuda")
    f1cat, lv = corr_fused.pool_f1_levels(
        torch.randn(b, h, h, c, generator=gen, device="cuda"), 4)
    base = torch.stack(torch.meshgrid(
        torch.arange(h, device="cuda"), torch.arange(h, device="cuda"),
        indexing="ij")).float().reshape(1, 2, h * h)
    coords = base + 3 * torch.randn(b, 2, h * h, generator=gen, device="cuda")
    coords[:, 0, :3] = -1e5
    g = torch.randn(b, len(lv.shapes) * 64, h * h, generator=gen, device="cuda")
    args = (f0, f1cat, coords, g, lv, 3)
    before = kernels.launches["corr_window_bwd"]
    got = corr_fused.corr_window_bwd(*args)
    assert kernels.launches["corr_window_bwd"] == before + 1
    want = corr_fused.corr_window_bwd(*args, plain=True)
    slack = corr_fused.bwd_sum_order_slack(*args)
    torch.cuda.synchronize()
    for x, y, s in zip(got, want, slack):
        assert bool(((x - y).abs() <= s + 1e-30).all())
    assert bool((got[0][:, :3] == 0).all())


@pytest.mark.parametrize("case", ["flow_sigma_8", "all_far_out"])
def test_corr_window_bwd_large_flows(gen, case):
    """K5 at the train step's coarse grid (115 x 115, C = 128) where most
    taps leave a block's shared-memory region: coords carrying flows of
    sigma = 8 px (they then take the global path), or every coord far out
    of range (no cotangent reaches f0 or f1). Within the fp32 sum-order
    slack of the plain version."""
    h, c = 115, 128
    f0 = torch.randn(1, h * h, c, generator=gen, device="cuda")
    f1cat, lv = corr_fused.pool_f1_levels(
        torch.randn(1, h, h, c, generator=gen, device="cuda"), 4)
    base = torch.stack(torch.meshgrid(
        torch.arange(h, device="cuda"), torch.arange(h, device="cuda"),
        indexing="ij")).float().reshape(1, 2, h * h)
    if case == "flow_sigma_8":
        coords = base + 8 * torch.randn(1, 2, h * h, generator=gen, device="cuda")
    else:
        coords = torch.where(torch.rand(1, 2, h * h, generator=gen,
                                        device="cuda") < 0.5, -1e5, 3e4)
    g = torch.randn(1, len(lv.shapes) * 64, h * h, generator=gen, device="cuda")
    args = (f0, f1cat, coords, g, lv, 3)
    got = corr_fused.corr_window_bwd(*args)
    want = corr_fused.corr_window_bwd(*args, plain=True)
    slack = corr_fused.bwd_sum_order_slack(*args)
    torch.cuda.synchronize()
    for x, y, s in zip(got, want, slack):
        assert bool(((x - y).abs() <= s + 1e-30).all())
    if case == "all_far_out":
        assert bool((got[0] == 0).all()) and bool((got[1] == 0).all())
    else:
        assert float(got[1].abs().max()) > 0


def test_knn_banded_contract(gen):
    """x-sorted clouds as the trainer sorts them; the last chunk of queries
    lies beyond the band. Against the exact plain version."""
    b, nq, nr = 1, 8 * 4096, 16384
    refs = (torch.rand(b, nr, 3, generator=gen, device="cuda") - 0.5) * 116
    refs = torch.gather(refs, 1, refs[..., 0].argsort(-1)[..., None].expand(-1, -1, 3))
    q = refs[:, torch.randint(0, nr, (nq,), generator=gen, device="cuda")]
    q = torch.gather(q, 1, q[..., 0].argsort(-1)[..., None].expand(-1, -1, 3))
    q = q + 0.3 * torch.randn(q.shape, generator=gen, device="cuda")
    q[:, -512:, 0] += 100.0
    qv = torch.rand(b, nq, generator=gen, device="cuda") > 0.05
    rv = torch.ones(b, nr, dtype=torch.bool, device="cuda")
    rv[:, -100:] = False
    before = kernels.launches["knn_banded"]
    d, idx = knn_banded.nn_1_sorted(q, refs, qv, rv)
    assert kernels.launches["knn_banded"] == before + 1
    dp, ip = knn_banded.nn_1_sorted(q, refs, qv, rv, plain=True)
    rep = knn_banded.contract_report(q, refs, qv, rv, 8.0, d, idx, dp, ip)
    assert rep["below_exact"] == 0 and rep["in_band_mismatch"] == 0, rep
    assert rep["in_band"] > 0.9 * int(qv.sum()), rep
    assert bool((d[:, -512:][qv[:, -512:]] == knn_banded.BIG).all())
    # every valid query against the exact search of its band
    db, ib = knn_banded.nn_1_sorted_band_plain(q, refs, qv, rv, 8.0)
    band = knn_banded.contract_report(q, refs, qv, rv, float("inf"), d, idx,
                                      db, ib)
    assert band["below_exact"] == 0 and band["in_band_mismatch"] == 0, band


def _cell_sorted(pts, res=0.5):
    """Rows sorted by BEV cell, x-major (a stable sort, as the trainer's):
    within one x-row of cells x is not monotone."""
    rc = torch.floor((pts[..., :2] + 60.0) / res).long()
    inside = ((rc >= 0) & (rc < int(120 / res))).all(-1)
    cell = torch.where(inside, rc[..., 0] * 100000 + rc[..., 1], 10**12)
    perm = torch.sort(cell, dim=-1, stable=True).indices
    return torch.gather(pts, 1, perm[..., None].expand(-1, -1, pts.shape[-1]))


@pytest.mark.parametrize(
    "case", ["cell_sorted", "duplicates", "beyond_band", "far_coords"])
def test_knn_banded_matches_band_oracle(gen, case):
    """K6 against the exact search of each chunk's band
    (nn_1_sorted_band_plain) on every valid query, B = 2: cell-sorted
    clouds (x not monotone within a cell row; points outside the grid
    trail); duplicate refs and queries on refs (exact ties, lowest index);
    a query chunk beyond the band (d = BIG); queries at |coords| ~ 60 m
    with sparse refs, neighbours 5-8 m away, so the early stop meets the
    band's edge."""
    b, nq = 2, 8192
    nr = 512 if case == "far_coords" else 8192  # sparse: neighbours 5-8 m off
    refs = (torch.rand(b, nr, 3, generator=gen, device="cuda") - 0.5) * 116
    refs[:, -64:, :2] *= 1.5  # outside the grid: sorted to the tail
    if case == "duplicates":
        refs[:, 1::2] = refs[:, 0::2]
    refs = _cell_sorted(refs)
    if case == "far_coords":  # |x| in [50, 60] m
        q = (torch.rand(b, nq, 3, generator=gen, device="cuda") - 0.5) * 116
        u = torch.rand(b, nq, generator=gen, device="cuda")
        q[..., 0] = torch.where(u < 0.5, -50 - 20 * u, 50 + 20 * (u - 0.5))
    else:
        pick = torch.randint(0, nr, (b, nq), generator=gen, device="cuda")
        q = torch.gather(refs, 1, pick[..., None].expand(-1, -1, 3))
        noise = 0.3 * torch.randn(q.shape, generator=gen, device="cuda")
        if case == "duplicates":
            noise[:, ::5] = 0.0  # exactly on a duplicated ref
        q = q + noise
    q = _cell_sorted(q)
    if case == "beyond_band":  # past every ref, the grid's trailing ones too
        q[:, -512:, 0] += 200.0
    qv = torch.rand(b, nq, generator=gen, device="cuda") > 0.05
    rv = torch.rand(b, nr, generator=gen, device="cuda") > 0.02
    visited = torch.zeros(1, dtype=torch.int64, device="cuda")
    before = kernels.launches["knn_banded"]
    d, idx = knn_banded.nn_1_sorted(q, refs, qv, rv, visited=visited)
    assert kernels.launches["knn_banded"] == before + 1
    db, ib = knn_banded.nn_1_sorted_band_plain(q, refs, qv, rv, 8.0)
    rep = knn_banded.contract_report(q, refs, qv, rv, float("inf"), d, idx,
                                     db, ib)
    assert rep["below_exact"] == 0 and rep["in_band_mismatch"] == 0, rep
    if case == "duplicates":
        # of two identical valid refs (adjacent after the stable sort) the
        # lower index wins
        i = idx.long()
        r_at = torch.gather(refs, 1, i[..., None].expand(-1, -1, 3))
        r_prev = torch.gather(refs, 1, (i - 1).clamp(min=0)[..., None].expand(-1, -1, 3))
        twin = (i > 0) & (r_prev == r_at).all(-1) & torch.gather(
            rv, 1, (i - 1).clamp(min=0))
        assert not bool((twin & qv).any())
    if case == "beyond_band":
        assert bool((d[:, -512:][qv[:, -512:]] == knn_banded.BIG).all())
    qpen = torch.where(qv, 0.0, knn_banded.BIG)
    rpen = torch.where(rv, 0.0, knn_banded.BIG)
    ranges = knn_banded.band_ranges(q, qpen, refs, rpen, 8.0)
    tile_pairs = int((ranges[..., 1] - ranges[..., 0]).sum()) * 1024 * 512
    # the bound's count (pairs within the stop radius at the exact answer)
    # is work the sweep cannot skip
    needed = knn_banded.needed_pairs(q, refs, qv, rv, db)
    assert 0 < needed <= int(visited) <= tile_pairs


def test_train_step_kernels_vs_plain(gen):
    """A small fp32 SLIM train step through the kernels launches K1-K6 and
    matches the plain step from the same state."""
    from liso_tpu_torch.data.sample import FlowSample, PointCloud
    from liso_tpu_torch.train.slim_train import SlimTrainer

    kw = dict(num_iters=2, predict_weight_for_static_aggregation="sigmoid",
              use_static_aggr_flow_for_aggr_flow=True, device="cuda")
    pcs = [PointCloud((torch.rand(1, 4096, 4, generator=gen, device="cuda") - 0.5) * 36,
                      torch.ones(1, 4096, dtype=torch.bool, device="cuda"))
           for _ in range(2)]
    eye = torch.eye(4, device="cuda")[None]
    batch = FlowSample(pcs[0], pcs[1], eye, eye)
    out = []
    for plain in (False, True):
        tr = SlimTrainer(BevSetup((40.0, 40.0), (64, 64)), **kw)
        kernels.reset_launches()
        with kernels.plain_versions(plain):
            m = tr.train_step(batch)
        out.append(m)
        if not plain:
            # every kernel but K1-add and K4, which no path of the port
            # runs (the fused VJP replaced K4's two launches), and the eval
            # BN + ReLU (train mode)
            idle = ("grid_reduce_add", "grid_gather", "bn_relu_eval")
            assert all(kernels.launches[k] == 0 for k in idle)
            assert all(v > 0 for k, v in kernels.launches.items()
                       if k not in idle), kernels.launches
        else:
            assert all(v == 0 for v in kernels.launches.values()), kernels.launches
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(out[0][k], out[1][k], rtol=2e-3, atol=0)


@pytest.mark.parametrize(
    "b,n,nc,c,dtype",
    [
        (1, 65536, 846400, 64, torch.bfloat16),  # the adjoint of K4's check
        (1, 65536, 846400, 2, torch.float32),  # the decoder gather's C
        (2, 4096, 1000, 8, torch.float32),  # crowded cells
        (2, 4096, 5000, 3, torch.bfloat16),  # odd C: the scalar path
    ],
)
def test_grid_reduce_add_within_sum_order_bound(gen, b, n, nc, c, dtype):
    """K1-add against its plain version (fp32 sums, rounded once): within
    2 n 2^-24 sum|v| per cell, plus one ulp of the output type where it is
    bf16 (the two fp32 sums may round to neighbouring bf16 values)."""
    cells = _sorted_cells(gen, b, n, nc)
    g = torch.randn(b, n, c, generator=gen, device="cuda").to(dtype)
    before = kernels.launches["grid_reduce_add"]
    got = grid_scatter.grid_reduce_add(g, cells, nc)
    assert kernels.launches["grid_reduce_add"] == before + 1
    want = grid_scatter.grid_reduce_add(g, cells, nc, plain=True)
    absum = grid_scatter.grid_reduce_add(g.float().abs(), cells, nc, plain=True)
    cnt = grid_scatter.grid_reduce_add(torch.ones_like(g, dtype=torch.float32),
                                       cells, nc, plain=True)
    torch.cuda.synchronize()
    tol = 2 * cnt * 2.0**-24 * absum
    if dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(
            want.float().abs().clamp(min=1e-30))) - 7)
    assert got.dtype == dtype
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    assert bool((got[cnt == 0] == 0).all())


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("c,dtype", [(64, torch.bfloat16), (2, torch.float32),
                                     (3, torch.bfloat16)])
def test_grid_reduce_add_layouts(gen, layout, c, dtype):
    """K1-add within its sum-order bound on the edge layouts of
    tests/torch_grid_layouts.py: one_cell and crowded drive the long-cell
    path (a cell of more than 32 points is summed by the whole block),
    tile_edge and end_cells the tile bounds (1024 cells a block); empty
    cells exactly 0."""
    b, n, nc = 2, 32768 if layout == "one_cell" else 4096, 5000
    cells = torch.from_numpy(cell_layout(
        layout, np.random.RandomState(n + c), b, n, nc)).cuda()
    g = torch.randn(b, n, c, generator=gen, device="cuda").to(dtype)
    got = grid_scatter.grid_reduce_add(g, cells, nc)
    want = grid_scatter.grid_reduce_add(g, cells, nc, plain=True)
    absum = grid_scatter.grid_reduce_add(g.float().abs(), cells, nc, plain=True)
    cnt = grid_scatter.grid_reduce_add(torch.ones_like(g, dtype=torch.float32),
                                       cells, nc, plain=True)
    torch.cuda.synchronize()
    tol = 2 * cnt * 2.0**-24 * absum
    if dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(
            want.float().abs().clamp(min=1e-30))) - 7)
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    assert bool((got[cnt == 0] == 0).all())
    if layout in ("one_cell", "crowded"):
        assert int(cnt[..., 0].max()) > 32


def test_grid_gather_vjp_uses_k1_add(gen):
    """grid_gather's backward launches K1-add once and matches the plain
    backward within the fp32 sum-order bound."""
    cells = _sorted_cells(gen, 2, 4096, 512)
    grid = torch.randn(2, 512, 16, generator=gen, device="cuda")
    ct = torch.randn(2, 4096, 16, generator=gen, device="cuda")
    grads = []
    for plain in (False, True):
        x = grid.clone().requires_grad_()
        before = kernels.launches["grid_reduce_add"]
        (grid_scatter.grid_gather(x, cells, plain=plain) * ct).sum().backward()
        assert kernels.launches["grid_reduce_add"] == before + (0 if plain else 1)
        grads.append(x.grad)
    absum = grid_scatter.grid_reduce_add(ct.abs(), cells, 512, plain=True)
    cnt = grid_scatter.grid_reduce_add(torch.ones_like(ct), cells, 512, plain=True)
    torch.cuda.synchronize()
    assert bool(((grads[0] - grads[1]).abs() <= 2 * cnt * 2.0**-24 * absum).all())


def test_detector_train_step_kernels_vs_plain(gen):
    """A small fp32 detector train step launches K1 and the VJP once each and
    matches the plain step from the same seed (both fp32: the trainer turns
    TF32 off itself); predict_step keeps the same boxes. cuDNN runs its
    deterministic algorithms here, so that the two trainers' states differ
    only where K1 and the VJP differ from their plain versions (they do
    not)."""
    from liso_tpu_torch.ops.boxes import Boxes
    from liso_tpu_torch.train.detector_train import DetectorTrainer

    pts = (torch.rand(2, 4096, 4, generator=gen, device="cuda") - 0.5) * 36
    valid = torch.ones(2, 4096, dtype=torch.bool, device="cuda")
    target = Boxes.empty(8, batch=(2,), device="cuda")
    target.pos[:, :2] = torch.tensor([[5.0, 2.0, -1.0], [-8.0, -3.0, -1.0]],
                                     device="cuda")
    target.dims[:, :2] = torch.tensor([4.0, 2.0, 1.5], device="cuda")
    target.valid[:, :2] = True
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        out, preds = [], []
        for plain in (False, True):
            tr = DetectorTrainer(BevSetup((40.0, 40.0), (64, 64)), max_lr=1e-3,
                                 total_steps=100, device="cuda")
            kernels.reset_launches()
            with kernels.plain_versions(plain):
                out.append(tr.train_step(pts, valid, target))
                want = {k: 0 for k in kernels.launches}
                if not plain:
                    want.update(grid_scatter_max_occ=1, scatter_max_vjp=1)
                assert kernels.launches == want
                preds.append(tr.predict_step(pts, valid))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    for k in ("loss/total", "grad_norm"):
        torch.testing.assert_close(out[0][k], out[1][k], rtol=1e-4, atol=0)
    assert torch.equal(preds[0].valid, preds[1].valid)
    torch.testing.assert_close(preds[0].pos, preds[1].pos, rtol=1e-4, atol=1e-4)


def _cc_masks():
    """Masks for connected_components at the mining grid: blobs, a dense
    random field, and a serpentine corridor that hits the iteration cap."""
    rng = np.random.RandomState(0)
    blobs = np.zeros((512, 512), bool)
    for _ in range(150):
        r, c = rng.randint(0, 500, 2)
        blobs[r:r + rng.randint(1, 12), c:c + rng.randint(1, 12)] = True
    dense = rng.rand(512, 512) < 0.12
    snake = np.zeros((512, 64), bool)
    snake[::4] = True
    for r in range(0, 508, 4):
        snake[r:r + 5, 63 if (r // 4) % 2 == 0 else 0] = True
    return {"blobs": (blobs, 2, 256), "dense": (dense, 1, 256),
            "snake_cap": (snake, 0, 256)}


@pytest.mark.parametrize("case", ["blobs", "dense", "snake_cap"])
def test_connected_components_card_vs_cpu(gen, case):
    from liso_tpu_torch.ops import clustering

    mask, dilation, max_iters = _cc_masks()[case]
    m = torch.from_numpy(mask)
    want = clustering.connected_components(m, dilation, max_iters)
    got = clustering.connected_components(m.cuda(), dilation, max_iters)
    assert torch.equal(got.cpu(), want)
    stats_c = clustering.cluster_stats(want, k_max=100)
    stats_g = clustering.cluster_stats(got, k_max=100)
    assert torch.equal(stats_g.count.cpu(), stats_c.count)
    assert torch.equal(stats_g.valid.cpu(), stats_c.valid)
    v = stats_c.valid
    assert torch.allclose(stats_g.centroid_rc.cpu()[v], stats_c.centroid_rc[v],
                          atol=1e-3, rtol=0)


@pytest.mark.parametrize("method", ["jerk", "bike_model"])
def test_smoothing_cuda_graph_equals_eager(gen, method):
    """The captured iteration replays the eager loop's kernels: bitwise."""
    from liso_tpu_torch.tracker import smoothing

    t = torch.arange(24, dtype=torch.float32, device="cuda")
    pos = torch.stack([1.5 * t, 0.4 * t, torch.full_like(t, -0.8)], -1)[None]
    pos = pos + 0.15 * torch.randn(pos.shape, generator=gen, device="cuda")
    yaw = torch.full((1, 24, 1), 0.26, device="cuda")
    valid = torch.ones(1, 24, dtype=torch.bool, device="cuda")
    if method == "jerk":
        run = lambda g: smoothing.smooth_track_jerk(pos, valid, yaw,
                                                    max_iters=300, graph=g)
    else:
        vlen = torch.tensor([4.0], device="cuda")
        run = lambda g: smoothing.smooth_track_bike_model(
            pos[:, :12], valid[:, :12], yaw[:, :12], vlen, max_iters=100,
            graph=g)
    eager, graph = run(False), run(True)
    for a, b in zip(eager, graph):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["iou_bev", "iou_3d"])
def test_iou_matrix_host_on_the_card_vs_oracle(gen, mode):
    """od_metrics.iou_matrix_host computed on the card: within 2e-4 of the
    float64 oracle (tests/test_iou_nms.py's limit) and within 1e-5 of the
    same function on the CPU, on rotated, shifted and disjoint pairs."""
    from liso_tpu_torch.eval import iou_oracle
    from liso_tpu_torch.eval.od_metrics import iou_matrix_host

    rng = np.random.RandomState(0)

    def boxes(k):
        return {"pos": np.concatenate([rng.uniform(-8, 8, (k, 2)),
                                       rng.uniform(-1, 1, (k, 1))], -1).astype(np.float32),
                "dims": rng.uniform(1, 5, (k, 3)).astype(np.float32),
                "rot": rng.uniform(-np.pi, np.pi, (k, 1)).astype(np.float32)}

    gt, pred = boxes(12), boxes(40)
    pred["pos"][:12] = gt["pos"] + rng.normal(0, 0.3, (12, 3)).astype(np.float32)
    got = iou_matrix_host(gt, pred, mode, device="cuda")
    cpu = iou_matrix_host(gt, pred, mode, device="cpu")
    oracle = getattr(iou_oracle, "iou_matrix_bev" if mode == "iou_bev"
                     else "iou_matrix_3d")(gt["pos"], gt["dims"], gt["rot"],
                                          pred["pos"], pred["dims"], pred["rot"])
    assert got.shape == (12, 40) and (got > 0.1).sum() >= 6
    np.testing.assert_allclose(got, oracle, atol=2e-4, rtol=0)
    np.testing.assert_allclose(got, cpu, atol=1e-5, rtol=0)
