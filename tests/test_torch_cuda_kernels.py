"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: these tests need an NVIDIA GPU with the CUDA toolkit (nvcc)
and skip elsewhere. Run them on a GPU machine with
    python -m pytest tests/test_torch_cuda_kernels.py -q
"""
import pytest
import torch

from liso_tpu_torch import kernels, serve
from liso_tpu_torch.ops import corr_fused, grid_scatter, knn_banded
from liso_tpu_torch.ops.bev import BevSetup

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize(
    "b,n,nc,c,dtype",
    [
        (2, 4096, 128 * 128, 128, torch.bfloat16),
        (2, 4096, 1000, 64, torch.float32),
        (3, 2048, 64, 16, torch.bfloat16),  # many points per cell, ties
    ],
)
def test_grid_scatter_max_occ_bitwise(gen, b, n, nc, c, dtype):
    cells = torch.randint(0, nc + 8, (b, n), generator=gen, device="cuda")
    cells = torch.sort(cells.int(), dim=-1).values
    cells[cells >= nc] = torch.iinfo(torch.int32).max
    if b > 1:
        cells[-1] = nc  # an all-dropped sample
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


def test_serving_path_kernels_vs_plain(gen):
    """The whole slice at a small size, fp32: kernel path vs plain path."""
    _, slim, det = serve.build_models(grid=64, num_iters=2, device="cuda")
    pts = [torch.rand(2, 2048, 4, generator=gen, device="cuda") * 90 - 45
           for _ in range(2)]
    valid = torch.ones(2, 2048, dtype=torch.bool, device="cuda")
    kernels.reset_launches()
    got = serve.fused_forward(slim, det, pts[0], valid, pts[1], valid)
    assert kernels.launches == {**{k: 0 for k in kernels.launches},
                                "grid_scatter_max_occ": 3, "corr_window_fwd": 2}
    want = serve.fused_forward(slim, det, pts[0], valid, pts[1], valid, plain=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-3, rtol=1e-3)


def _sorted_cells(gen, b, n, nc):
    cells = torch.randint(0, nc + nc // 8, (b, n), generator=gen, device="cuda")
    cells = torch.sort(cells.int(), dim=-1).values
    cells[cells >= nc] = torch.iinfo(torch.int32).max
    return cells


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grid_gather_bitwise(gen, dtype):
    cells = _sorted_cells(gen, 2, 4096, 5000)
    grid = torch.randn(2, 5000, 64, generator=gen, device="cuda").to(dtype)
    before = kernels.launches["grid_gather"]
    got = grid_scatter.grid_gather(grid, cells)
    assert kernels.launches["grid_gather"] == before + 1
    want = grid_scatter.grid_gather(grid, cells, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_scatter_max_vjp_bitwise(gen):
    """The K1 backward through K4 (two launches) vs the plain VJP, with
    ties (features on a coarse lattice)."""
    cells = _sorted_cells(gen, 2, 4096, 512)
    feats = torch.round(torch.randn(2, 4096, 16, generator=gen, device="cuda") * 2)
    g = torch.randn(2, 512, 16, generator=gen, device="cuda")
    grads = []
    for plain in (False, True):
        f = feats.clone().requires_grad_()
        grid, _ = grid_scatter.grid_scatter_max_occ(f, cells, 512, plain=plain)
        before = kernels.launches["grid_gather"]
        (grid * g).sum().backward()
        assert kernels.launches["grid_gather"] == before + (0 if plain else 2)
        grads.append(f.grad)
    torch.cuda.synchronize()
    assert torch.equal(grads[0], grads[1])


def test_grid_reduce_add_c1_within_sum_order_bound(gen):
    r, n, nb = 6, 131072, 100352
    bins = torch.randint(0, 100000, (r, n), generator=gen, device="cuda").int()
    bins[:, :500] = 7
    bins[:, -100:] = torch.iinfo(torch.int32).max
    bins = torch.sort(bins, dim=-1).values
    vals = torch.randn(r, n, generator=gen, device="cuda")
    got = grid_scatter.grid_reduce_add_c1(vals, bins, nb)
    want = grid_scatter.grid_reduce_add_c1(vals, bins, nb, plain=True)
    absum = grid_scatter.grid_reduce_add_c1(vals.abs(), bins, nb, plain=True)
    cnt = grid_scatter.grid_reduce_add_c1(torch.ones_like(vals), bins, nb, plain=True)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 2 * cnt * 2.0**-24 * absum).all())


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
        m = tr.train_step(batch, plain=plain)
        out.append(m)
        if not plain:
            assert all(v > 0 for v in kernels.launches.values()), kernels.launches
        else:
            assert all(v == 0 for v in kernels.launches.values()), kernels.launches
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(out[0][k], out[1][k], rtol=2e-3, atol=0)
