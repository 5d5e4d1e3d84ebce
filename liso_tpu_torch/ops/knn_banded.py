"""1-NN with x-band pruning over cell-sorted clouds (port of
liso_tpu/ops/knn_pallas.py).

`nn_1_sorted` launches the CUDA kernel `kernels/knn_banded.cu` (K6) for
CUDA tensors and runs its plain version, the exact brute force `nn_1` of
ops/knn.py, where `kernels.use_plain` says: for CPU tensors, inside
`kernels.plain_versions()`, or when the caller passes `plain=True`.
`nn_1_sorted_band_plain` is the function the kernel computes, exact 1-NN
over each chunk's band of refs: the card checks hold the kernel to it on
every query.

Approximation contract of the kernel (`knn_pallas.py:13-17`): both clouds
are sorted ascending in x (x-major cell order qualifies); a chunk of 512
queries visits only the 1024-ref tiles whose x range meets the chunk's
x range widened by `margin`. Results equal the exact 1-NN (up to fp32
near-ties) for every query whose true neighbour lies within `margin`
metres in x; the others get the best match inside the band, or BIG when
the band is empty.

`nn_1_sorted_diff` is the differentiable form: d = ||q - nn(q)||^2 with
the neighbour held fixed, so dd/dq = 2 (q - nn) (`knn_pallas.py:180-215`).
"""
from __future__ import annotations

import torch

from liso_tpu_torch import kernels
from liso_tpu_torch.ops.knn import BIG, nn_1

_QC = 512  # queries per chunk
_RT = 1024  # refs per tile
_SUB = 32  # refs per sub-tile of the kernel's x bounds


def nn_1_sorted_plain(q, refs, q_valid, r_valid):
    """Exact batched 1-NN: q [B, Nq, >=3], refs [B, Nr, >=3] -> (sq_dist
    [B, Nq], idx [B, Nq] int32)."""
    out = [nn_1(q[i, :, :3], refs[i, :, :3], q_valid[i], r_valid[i],
                chunk=8192 if q.device.type == "cuda" else 2048)
           for i in range(q.shape[0])]
    return torch.stack([d for d, _ in out]), torch.stack([i for _, i in out])


def _nanmin_max(x: torch.Tensor, dim: int):
    """(min, max) over `dim` ignoring NaN; NaN where every entry is NaN."""
    nan = torch.isnan(x)
    lo = torch.where(nan, float("inf"), x).amin(dim)
    hi = torch.where(nan, float("-inf"), x).amax(dim)
    empty = nan.all(dim)
    return (torch.where(empty, float("nan"), lo),
            torch.where(empty, float("nan"), hi))


def band_ranges(q, qpen, refs, rpen, margin: float):
    """Per (batch, 512-query chunk) the contiguous ref-tile range [t_lo,
    t_hi) to visit, computed as the TPU wrapper does
    (`knn_pallas.py:105-137`). Returns int32 [B, n_chunks, 2]."""
    b, nq, _ = q.shape
    nr = refs.shape[1]
    nq_pad = -(-nq // _QC) * _QC
    nr_pad = -(-nr // _RT) * _RT
    nan = float("nan")
    rx = torch.where(rpen > 0, nan, refs[..., 0])
    rx = torch.nn.functional.pad(rx, (0, nr_pad - nr), value=nan)
    tlo, thi = _nanmin_max(rx.reshape(b, nr_pad // _RT, _RT), -1)
    # empty (all-invalid) tiles can only trail, so +BIG on both ends keeps
    # tlo and thi ascending, as searchsorted needs
    tlo = torch.nan_to_num(tlo, nan=BIG)
    thi = torch.nan_to_num(thi, nan=BIG)
    n_nonempty = (~torch.isnan(rx.reshape(b, -1, _RT))).any(-1).sum(-1)
    qx = torch.where(qpen > 0, nan, q[..., 0])
    qx = torch.nn.functional.pad(qx, (0, nq_pad - nq), value=nan)
    qlo, qhi = _nanmin_max(qx.reshape(b, nq_pad // _QC, _QC), -1)
    qlo = torch.nan_to_num(qlo, nan=BIG)
    qhi = torch.nan_to_num(qhi, nan=-BIG)
    t_lo = torch.searchsorted(thi.contiguous(), (qlo - margin).contiguous())
    t_hi = torch.searchsorted(tlo.contiguous(), (qhi + margin).contiguous(),
                              right=True)
    # never visit trailing empty tiles
    t_hi = torch.minimum(t_hi, n_nonempty[:, None])
    t_hi = torch.maximum(t_hi, t_lo)
    return torch.stack([t_lo, t_hi], dim=-1).to(torch.int32)


def nn_1_sorted_band_plain(q, refs, q_valid, r_valid, margin: float = 8.0):
    """What the kernel computes: per 512-query chunk the exact fp32 1-NN
    over the refs of its band (`band_ranges`), first argmin of the metric
    |q|^2 + (|r|^2 + pen - 2 q.r), one chunk at a time. Invalid queries,
    and queries whose band is empty, get (BIG, 0). q [B, Nq, >=3], refs
    [B, Nr, >=3] -> (sq_dist [B, Nq] fp32, idx [B, Nq] int32)."""
    q = q[..., :3].float()
    r = refs[..., :3].float()
    qpen = torch.where(q_valid, 0.0, BIG)
    rpen = torch.where(r_valid, 0.0, BIG)
    ranges = band_ranges(q, qpen, r, rpen, margin).tolist()
    b, nq, _ = q.shape
    nr = r.shape[1]
    d = torch.full((b, nq), BIG, device=q.device)
    idx = torch.zeros(b, nq, dtype=torch.int64, device=q.device)
    r2pen = (r * r).sum(-1) + rpen
    for bi in range(b):
        for ci, (lo, hi) in enumerate(ranges[bi]):
            s, e = ci * _QC, min((ci + 1) * _QC, nq)
            ref = slice(lo * _RT, min(hi * _RT, nr))
            if ref.start >= ref.stop or s >= e:
                continue
            qc = q[bi, s:e]
            sq = ((qc * qc).sum(-1)[:, None]
                  + (r2pen[bi, ref][None] - 2.0 * qc @ r[bi, ref].T))
            best, arg = sq.min(-1)
            upd = best < d[bi, s:e]
            d[bi, s:e] = torch.where(upd, best, d[bi, s:e])
            idx[bi, s:e] = torch.where(upd, arg + ref.start, idx[bi, s:e])
    d = torch.where(q_valid, d.clamp(min=0.0), BIG)
    return d, torch.where(q_valid, idx, 0).to(torch.int32)


def stop_radius(q, d_best):
    """The kernel's stopping radius in x for a query at `q` [..., 3] whose
    best squared distance so far is `d_best`: sqrt((d_best + 2^-17 |q|^2)
    (1 + 2^-16)), the x gap beyond which no ref can beat or tie it under
    the fp32 metric (knn_banded.cu)."""
    q = q[..., :3].double()
    return torch.sqrt((d_best.double() + 2.0**-17 * (q * q).sum(-1))
                      * (1.0 + 2.0**-16))


def needed_pairs(q, refs, q_valid, r_valid, d_exact, margin: float = 8.0) -> int:
    """The (valid query, valid ref) pairs that an exact search of each
    chunk's band, pruned by x alone, must test once it knows the answer:
    per valid query, the valid refs of its band whose x lies within
    `stop_radius(q, d_exact)` of the query's. This is the work these
    inputs need, and the kernel's bound counts it; the kernel's own count
    (`visited`) exceeds it by what its warp-wide cut and sub-tiles cost.
    d_exact: the band oracle's distances (`nn_1_sorted_band_plain`)."""
    q3 = q[..., :3].float()
    r = refs[..., :3].float()
    qpen = torch.where(q_valid, 0.0, BIG)
    rpen = torch.where(r_valid, 0.0, BIG)
    ranges = band_ranges(q3, qpen, r, rpen, margin).long()
    b, nq, _ = q3.shape
    nr = r.shape[1]
    nr_pad = -(-nr // _RT) * _RT
    # per tile, its valid refs' x sorted (+inf for the others)
    rx = torch.nn.functional.pad(
        torch.where(r_valid, r[..., 0], float("inf")), (0, nr_pad - nr),
        value=float("inf")).reshape(b, -1, _RT).sort(-1).values.double()
    rad = stop_radius(q3, d_exact)
    qx = q3[..., 0].double()
    lo, hi = (qx - rad).contiguous(), (qx + rad).contiguous()
    chunk = torch.arange(nq, device=q.device) // _QC
    t_lo, t_hi = ranges[:, chunk, 0], ranges[:, chunk, 1]
    total = 0
    for t in range(nr_pad // _RT):
        in_band = q_valid & (t_lo <= t) & (t < t_hi)
        sx = rx[:, t].contiguous()
        n = (torch.searchsorted(sx, hi, right=True)
             - torch.searchsorted(sx, lo))
        total += int(torch.where(in_band, n, 0).sum())
    return total


def sub_tile_bounds(rx, r_valid, nr_pad: int):
    """The kernel's x bounds per 32-ref sub-tile of the padded refs, over
    the valid refs' x: (suffix minimum of the minima from sub-tile s to the
    end, +inf where no valid ref follows; prefix maximum of the maxima up
    to s, -inf where none precedes), each fp32 [B, Nr_pad / 32]."""
    b, nr = rx.shape
    pad = (0, nr_pad - nr)
    lo = torch.nn.functional.pad(
        torch.where(r_valid, rx, float("inf")), pad, value=float("inf"))
    hi = torch.nn.functional.pad(
        torch.where(r_valid, rx, float("-inf")), pad, value=float("-inf"))
    lo = lo.reshape(b, -1, _SUB).amin(-1)
    hi = hi.reshape(b, -1, _SUB).amax(-1)
    suf_min = lo.flip(-1).cummin(-1).values.flip(-1)
    pre_max = hi.cummax(-1).values
    return suf_min.contiguous(), pre_max.contiguous()


def kernel_inputs(q, refs, q_valid, r_valid, margin: float):
    """The kernel's device inputs: q [B, Nq, 3] fp32, q_valid as uint8,
    ref rows (x, y, z, |r|^2 + pen) padded to a multiple of 1024 with pad
    rows at coords 0 and BIG, the band's tile ranges, the sub-tile x
    bounds (`sub_tile_bounds`) and Nr_pad."""
    dev = q.device
    if refs.device != dev or q_valid.device != dev or r_valid.device != dev:
        raise ValueError("q, refs and the masks must lie on one CUDA device")
    nr = refs.shape[1]
    q = q[..., :3].to(torch.float32).contiguous()
    r = refs[..., :3].to(torch.float32)
    qpen = torch.where(q_valid, 0.0, BIG)
    rpen = torch.where(r_valid, 0.0, BIG)
    nr_pad = -(-nr // _RT) * _RT
    rows = torch.cat([r, ((r * r).sum(-1) + rpen)[..., None]], dim=-1)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, nr_pad - nr))
    rows[:, nr:, 3] = BIG
    return {
        "q": q,
        "q_valid": q_valid.to(torch.uint8).contiguous(),
        "rows": rows.contiguous(),
        "ranges": band_ranges(q, qpen, r, rpen, margin),
        "bounds": sub_tile_bounds(r[..., 0], r_valid, nr_pad),
        "nr_pad": nr_pad,
    }


def _nn1_kernel(q, refs, q_valid, r_valid, margin, visited=None):
    dev = q.device
    if visited is not None and (visited.device != dev
                                or visited.dtype != torch.int64
                                or visited.numel() != 1):
        raise ValueError("visited must be one int64 on the queries' device")
    b, nq, _ = q.shape
    nr = refs.shape[1]
    x = kernel_inputs(q, refs, q_valid, r_valid, margin)
    suf_min, pre_max = x["bounds"]
    dist = torch.empty(b, nq, dtype=torch.float32, device=dev)
    idx = torch.empty(b, nq, dtype=torch.int32, device=dev)
    fn = kernels.function("knn_banded")
    kernels.check(
        fn(
            x["q"].data_ptr(), x["q_valid"].data_ptr(), x["rows"].data_ptr(),
            x["ranges"].data_ptr(), suf_min.data_ptr(), pre_max.data_ptr(),
            dist.data_ptr(), idx.data_ptr(),
            None if visited is None else visited.data_ptr(),
            b, nq, x["nr_pad"], kernels.stream(dev),
        ),
        "knn_banded",
    )
    kernels.launches["knn_banded"] += 1
    dist = torch.where(q_valid, dist.clamp(min=0.0), BIG)
    idx = torch.where(q_valid, idx.clamp(0, nr - 1), 0)
    return dist, idx


def nn_1_sorted(q, refs, q_valid, r_valid, margin: float = 8.0,
                plain: bool = False, visited: torch.Tensor | None = None):
    """Batched 1-NN for x-sorted clouds (see the module docstring).
    q [B, Nq, >=3], refs [B, Nr, >=3], bool masks -> (sq_dist [B, Nq] fp32,
    idx [B, Nq] int32); invalid queries get (BIG, 0). `visited`, a
    one-element int64 tensor on the card, receives the count of (valid
    query, ref) pairs the kernel tested (a measurement; the plain version
    leaves it as it is)."""
    if kernels.use_plain(q, plain):
        return nn_1_sorted_plain(q, refs, q_valid, r_valid)
    return _nn1_kernel(q, refs, q_valid, r_valid, margin, visited)


def contract_report(q, refs, q_valid, r_valid, margin, d, idx, d_exact,
                    idx_exact) -> dict:
    """How the banded result (d, idx) holds to the approximation contract
    against the exact one (d_exact, idx_exact). Per query, `slack` =
    2^-21 (|q| + |r|)^2 with r the exact neighbour: the fp32 metric
    |q|^2 + |r|^2 - 2 q.r rounds to within a few ulps of its largest term,
    twice. Counts of valid queries (violations must be 0):
      below_exact: d < d_exact - slack (the band may only remove refs);
      in_band: the exact neighbour lies within `margin` in x;
      in_band_mismatch: of those, |d - d_exact| > slack, or the true
        (float64) distance to idx exceeds that to idx_exact by > 2 slack
        (a different index is allowed only for an fp32 near-tie);
      index_differs: of those, idx != idx_exact (near-ties)."""
    q = q[..., :3].double()
    r = refs[..., :3].double()

    def at(i):
        return torch.gather(r, 1, i.long()[..., None].expand(-1, -1, 3))

    r_ex, r_got = at(idx_exact), at(idx)
    slack = 2.0**-21 * (q.norm(dim=-1) + r_ex.norm(dim=-1)) ** 2
    d, d_exact = d.double(), d_exact.double()
    true_got = ((q - r_got) ** 2).sum(-1)
    true_ex = ((q - r_ex) ** 2).sum(-1)
    in_band = q_valid & ((q[..., 0] - r_ex[..., 0]).abs() < margin)
    bad = ((d - d_exact).abs() > slack) | (true_got > true_ex + 2 * slack)
    return {
        "valid": int(q_valid.sum()),
        "below_exact": int((q_valid & (d < d_exact - slack)).sum()),
        "in_band": int(in_band.sum()),
        "in_band_mismatch": int((in_band & bad).sum()),
        "index_differs": int((in_band & (idx != idx_exact)).sum()),
        "max_slack": float(slack[q_valid].max()) if bool(q_valid.any()) else 0.0,
    }


class _NN1SortedDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, refs, q_valid, r_valid, margin):
        d, idx = nn_1_sorted(q.detach(), refs, q_valid, r_valid, margin)
        ctx.save_for_backward(q, refs, idx, q_valid)
        ctx.mark_non_differentiable(idx)
        return d, idx

    @staticmethod
    def backward(ctx, g, g_idx):
        q, refs, idx, q_valid = ctx.saved_tensors
        nn = torch.gather(
            refs[..., :3], 1, idx.long()[..., None].expand(-1, -1, 3)
        )
        dq = 2.0 * (q[..., :3] - nn) * g[..., None]
        dq = torch.where(q_valid[..., None], dq, 0.0)
        if q.shape[-1] > 3:
            dq = torch.nn.functional.pad(dq, (0, q.shape[-1] - 3))
        return dq, None, None, None, None


def nn_1_sorted_diff(q, refs, q_valid, r_valid, margin: float = 8.0):
    """Differentiable 1-NN distance: sq_dist [B, Nq] with the neighbour
    held fixed (dd/dq = 2 (q - nn)); refs are data and get no cotangent."""
    return _NN1SortedDiff.apply(q, refs, q_valid, r_valid, margin)[0]
