"""Fixed-K radius neighbour query over a sorted cell-hash grid (port of
liso_tpu/ops/ball_query.py, which is jnp, not a Pallas kernel).

Points are bucketed into radius-sized BEV cells by one stable sort on the
cell id, and every query scans its 3x3 cell neighbourhood (a superset of
the radius-r disk) with a fixed candidate budget per cell. The k nearest
in-radius candidates are returned, ties in candidate order: the JAX
function takes `top_k(-d2, k)`, whose ties go to the lower index, and a
stable ascending sort of d2 gives the same order.
"""
from __future__ import annotations

import torch

_BIG = 1e9


def grid_ball_query(points: torch.Tensor, valid: torch.Tensor, *,
                    radius: float, k: int, bev_range_m=(100.0, 100.0),
                    cap: int | None = None):
    """points [B, N, >=3], valid [B, N] -> (idx [B, N, k] int64 into each
    cloud, mask [B, N, k] bool).

    Neighbours are the k nearest points with planar cell distance <= 1 cell
    and 3D distance <= radius (self included). Queries or candidates
    outside `valid` or the BEV range give mask=False slots. `cap` bounds the
    candidates drawn per cell (default max(2k, 16))."""
    if cap is None:
        cap = max(2 * k, 16)
    b, n = valid.shape
    dev = points.device
    xyz = points[..., :3]
    hx = 0.5 * float(bev_range_m[0])
    hy = 0.5 * float(bev_range_m[1])
    W = max(int(2.0 * hx / radius + 0.5), 1)
    H = max(int(2.0 * hy / radius + 0.5), 1)

    col = torch.floor((xyz[..., 0] + hx) / radius).to(torch.int64)
    row = torch.floor((xyz[..., 1] + hy) / radius).to(torch.int64)
    in_grid = (col >= 0) & (col < W) & (row >= 0) & (row < H) & valid
    # invalid or off-grid points go to an overflow bucket, never scanned
    cid = torch.where(in_grid, row * W + col, H * W)

    sorted_cid, order = torch.sort(cid, dim=-1, stable=True)
    sorted_xyz = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    starts = torch.searchsorted(
        sorted_cid,
        torch.arange(H * W + 1, device=dev).expand(b, -1).contiguous())

    # the 3x3 neighbourhood's cell ids per query
    dr = torch.tensor([-1, -1, -1, 0, 0, 0, 1, 1, 1], device=dev)
    dc = torch.tensor([-1, 0, 1, -1, 0, 1, -1, 0, 1], device=dev)
    nr = row[..., None] + dr
    nc = col[..., None] + dc
    cell_ok = (nr >= 0) & (nr < H) & (nc >= 0) & (nc < W) & in_grid[..., None]
    ncid = torch.where(cell_ok, nr * W + nc, 0).reshape(b, n * 9)
    s0 = torch.gather(starts, 1, ncid)
    cnt = (torch.gather(starts, 1, ncid + 1) - s0).clamp(max=cap)
    s0, cnt = s0.reshape(b, n, 9), cnt.reshape(b, n, 9)
    cnt = torch.where(cell_ok, cnt, 0)

    j = torch.arange(cap, device=dev)
    cand = (s0[..., None] + j).clamp(0, n - 1)  # [B, N, 9, cap] sorted idx
    in_bucket = j < cnt[..., None]
    flat_cand = cand.reshape(b, n * 9 * cap)
    cand_xyz = torch.gather(
        sorted_xyz, 1, flat_cand[..., None].expand(-1, -1, 3)
    ).reshape(b, n, 9, cap, 3)
    d2 = ((cand_xyz - xyz[:, :, None, None, :]) ** 2).sum(-1)
    ok = in_bucket & (d2 <= radius * radius)
    key = torch.where(ok, d2, _BIG).reshape(b, n, 9 * cap)
    key_s, pos = torch.sort(key, dim=-1, stable=True)
    pos = pos[..., :k]
    idx_sorted = torch.gather(flat_cand.reshape(b, n, 9 * cap), 2, pos)
    idx = torch.gather(order, 1, idx_sorted.reshape(b, n * k)).reshape(b, n, k)
    mask = key_s[..., :k] < _BIG * 0.5
    return idx, mask
