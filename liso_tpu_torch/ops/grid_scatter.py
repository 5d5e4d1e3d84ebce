"""Dense-BEV-grid scatter and gather over cell-sorted points (port of
liso_tpu/ops/grid_scatter_pallas.py).

  * `grid_scatter_max_occ` - the max + occupancy forward of
    `grid_reduce_with_occ(feats, cells, num_cells, "max")` (kernel K1,
    `kernels/grid_scatter_max.cu`), differentiable with the TPU VJP
    (`grid_scatter_pallas.py:459-470`):
        winner = feats == gather(grid, cells)
        dfeats = where(winner, gather(g, cells), 0)
    so every tied maximum gets the full cotangent;
  * `scatter_max_vjp` - that VJP in one pass (kernel
    `kernels/scatter_max_vjp.cu`), the backward of `grid_scatter_max_occ`;
  * `grid_gather` - per-point row gather at any C, drop bucket reads 0
    (kernel K4, `kernels/grid_gather.cu`), the TPU VJP's gather;
    differentiable in the grid with `grid_reduce_add` as its backward;
  * `grid_reduce_add` - per-cell sums of cell-sorted point rows (kernel
    K1-add, `kernels/grid_reduce_add.cu`), the `op="add"` of `grid_reduce`;
  * `grid_reduce_add_c1` - scatter-add of scalar values over sorted bins
    (kernel K3, `kernels/grid_reduce_add_c1.cu`), the C == 1 add of
    `grid_reduce`.

Each launches its CUDA kernel for CUDA tensors and runs its plain PyTorch
version (`*_plain`) where `kernels.use_plain` says: for CPU tensors, inside
`kernels.plain_versions()`, or when the caller passes `plain=True` (tests
and chip_smoke.py compare the two). A backward runs plain where its
forward did, or inside a scope (`kernels.plain_versions`).
"""
from __future__ import annotations

import torch

from liso_tpu_torch import kernels
from liso_tpu_torch.ops.scatter import scatter_max_grid


def _check_cuda(*tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"tensors on {[str(t.device) for t in tensors]}: all must lie on "
            "one CUDA device"
        )
    return dev


def grid_scatter_max_occ_plain(
    feats: torch.Tensor, cells: torch.Tensor, num_cells: int
):
    """feats [B, N, C], cells [B, N] int32 (ids >= num_cells, including the
    int32-max pad, are dropped) -> (grid [B, num_cells, C] in feats' dtype,
    empty cells 0; occ [B, num_cells, 1] fp32, 1 where a point landed)."""
    grid = scatter_max_grid(feats, cells, num_cells, fill=0.0)
    ids = cells.long().clamp(max=num_cells)
    cnt = torch.zeros(
        cells.shape[0], num_cells + 1, dtype=torch.float32, device=cells.device
    )
    cnt.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.float32))
    occ = (cnt[:, :num_cells] > 0).to(torch.float32).unsqueeze(-1)
    return grid, occ


def _grid_scatter_max_occ_fwd(feats, cells, num_cells, plain):
    if kernels.use_plain(feats, plain):
        return grid_scatter_max_occ_plain(feats, cells, num_cells)
    _check_cuda(feats, cells)
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"feats must be fp32 or bf16, got {feats.dtype}")
    if feats.dim() != 3 or cells.shape != feats.shape[:2]:
        raise ValueError(f"feats {tuple(feats.shape)}, cells {tuple(cells.shape)}")
    b, n, c = feats.shape
    if c % 4:
        raise ValueError(f"the CUDA kernel takes C % 4 == 0, got C = {c}")
    feats = feats.contiguous()
    if feats.data_ptr() % (4 * feats.element_size()):
        raise ValueError("feats must be aligned to 4 elements (vector loads)")
    cells = cells.to(torch.int32).contiguous()
    grid = torch.empty((b, num_cells, c), dtype=feats.dtype, device=feats.device)
    occ = torch.empty((b, num_cells, 1), dtype=torch.float32, device=feats.device)
    kernels.check(
        kernels.function("grid_scatter_max")(
            feats.data_ptr(), cells.data_ptr(), grid.data_ptr(),
            occ.data_ptr(), b, n, c, num_cells,
            int(feats.dtype == torch.bfloat16),
            kernels.stream(feats.device),
        ),
        "grid_scatter_max_occ",
    )
    kernels.launches["grid_scatter_max_occ"] += 1
    return grid, occ


class _GridScatterMaxOcc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, cells, num_cells, plain):
        plain = kernels.use_plain(feats, plain)
        grid, occ = _grid_scatter_max_occ_fwd(feats, cells, num_cells, plain)
        ctx.save_for_backward(feats, cells, grid)
        ctx.plain = plain
        ctx.mark_non_differentiable(occ)  # piecewise constant in feats
        return grid, occ

    @staticmethod
    def backward(ctx, g_grid, g_occ):
        feats, cells, grid = ctx.saved_tensors
        if g_grid is None:
            return None, None, None, None
        return (scatter_max_vjp(feats, cells, grid, g_grid, ctx.plain),
                None, None, None)


def grid_scatter_max_occ(
    feats: torch.Tensor, cells: torch.Tensor, num_cells: int,
    plain: bool = False,
):
    """Scatter-max of cell-sorted point features into a dense grid, with
    occupancy. Cell ids MUST be ascending per sample. Same contract as
    `grid_scatter_max_occ_plain`; differentiable in `feats` (TPU VJP, see
    the module docstring). Without a gradient to track it skips the
    autograd Function, and with it the Function's host cost."""
    if not (feats.requires_grad and torch.is_grad_enabled()):
        return _grid_scatter_max_occ_fwd(feats, cells, num_cells, plain)
    return _GridScatterMaxOcc.apply(feats, cells, num_cells, plain)


def scatter_max_vjp_plain(feats: torch.Tensor, cells: torch.Tensor,
                          grid: torch.Tensor, g_grid: torch.Tensor):
    """The TPU VJP of the scatter-max: feats [B, N, C], cells [B, N], grid
    [B, NC, C] (the forward's), g_grid [B, NC, C] (its cotangent) -> dfeats
    [B, N, C]: g_grid's row at the point's cell where the feature equals
    the grid's (every tied maximum wins), +0.0 elsewhere and for the drop
    bucket (ids >= NC)."""
    winner = feats == grid_gather_plain(grid, cells)
    return torch.where(winner, grid_gather_plain(g_grid, cells), 0.0)


def scatter_max_vjp(feats: torch.Tensor, cells: torch.Tensor,
                    grid: torch.Tensor, g_grid: torch.Tensor,
                    plain: bool = False):
    """The scatter-max VJP in one kernel launch; bitwise the same as
    `scatter_max_vjp_plain` (same contract)."""
    if kernels.use_plain(feats, plain):
        return scatter_max_vjp_plain(feats, cells, grid, g_grid)
    _check_cuda(feats, cells, grid, g_grid)
    if feats.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != feats.dtype for t in (grid, g_grid)):
        raise TypeError(f"feats, grid, g_grid must share fp32 or bf16, got "
                        f"{feats.dtype}, {grid.dtype}, {g_grid.dtype}")
    if (feats.dim() != 3 or grid.dim() != 3
            or cells.shape != feats.shape[:2]
            or grid.shape[::2] != feats.shape[::2]
            or g_grid.shape != grid.shape):
        raise ValueError(f"feats {tuple(feats.shape)}, cells "
                         f"{tuple(cells.shape)}, grid {tuple(grid.shape)}, "
                         f"g_grid {tuple(g_grid.shape)}")
    b, n, c = feats.shape
    nc = grid.shape[1]
    if c % 4:
        raise ValueError(f"the CUDA kernel takes C % 4 == 0, got C = {c}")
    feats, grid, g_grid = (t.contiguous() for t in (feats, grid, g_grid))
    if any(t.data_ptr() % (4 * t.element_size()) for t in (feats, grid, g_grid)):
        raise ValueError("feats, grid, g_grid must be aligned to 4 elements "
                         "(vector loads)")
    cells = cells.to(torch.int32).contiguous()
    out = torch.empty_like(feats)
    kernels.check(
        kernels.function("scatter_max_vjp")(
            feats.data_ptr(), cells.data_ptr(), grid.data_ptr(),
            g_grid.data_ptr(), out.data_ptr(), b, n, c, nc,
            int(feats.dtype == torch.bfloat16),
            kernels.stream(feats.device),
        ),
        "scatter_max_vjp",
    )
    kernels.launches["scatter_max_vjp"] += 1
    return out


def grid_gather_plain(grid: torch.Tensor, cells: torch.Tensor):
    """grid [B, NC, C], cells [B, N] -> [B, N, C]: row cells[b, p] of
    grid[b]; ids >= NC (the drop bucket) read 0."""
    nc, c = grid.shape[1], grid.shape[2]
    idx = cells.long().clamp(0, nc - 1).unsqueeze(-1).expand(-1, -1, c)
    vals = torch.gather(grid, 1, idx)
    return torch.where((cells < nc).unsqueeze(-1), vals, 0.0)


def _grid_gather_fwd(grid, cells, plain):
    if kernels.use_plain(grid, plain):
        return grid_gather_plain(grid, cells)
    _check_cuda(grid, cells)
    if grid.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grid must be fp32 or bf16, got {grid.dtype}")
    if grid.dim() != 3 or cells.dim() != 2 or cells.shape[0] != grid.shape[0]:
        raise ValueError(f"grid {tuple(grid.shape)}, cells {tuple(cells.shape)}")
    b, nc, c = grid.shape
    n = cells.shape[1]
    grid = grid.contiguous()
    cells = cells.to(torch.int32).contiguous()
    out = torch.empty(b, n, c, dtype=grid.dtype, device=grid.device)
    kernels.check(
        kernels.function("grid_gather")(
            grid.data_ptr(), cells.data_ptr(), out.data_ptr(), b, n, c, nc,
            int(grid.dtype == torch.bfloat16), kernels.stream(grid.device),
        ),
        "grid_gather",
    )
    kernels.launches["grid_gather"] += 1
    return out


class _GridGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, cells, plain):
        plain = kernels.use_plain(grid, plain)
        ctx.save_for_backward(cells)
        ctx.num_cells, ctx.plain = grid.shape[1], plain
        return _grid_gather_fwd(grid, cells, plain)

    @staticmethod
    def backward(ctx, g):
        (cells,) = ctx.saved_tensors
        return grid_reduce_add(g.contiguous(), cells, ctx.num_cells,
                               ctx.plain), None, None


def grid_gather(grid: torch.Tensor, cells: torch.Tensor, plain: bool = False):
    """Per-point row gather; same contract as `grid_gather_plain`.
    Differentiable in `grid` with the TPU VJP (`grid_scatter_pallas.py:
    476-495`): the cotangent of each grid row is the sum of its points'
    cotangent rows (`grid_reduce_add`). Cell ids MUST be ascending per
    sample when `grid` requires a gradient (checked: the backward reads each
    cell's rows as one range); a gather without gradient takes any order,
    and skips the autograd Function and its host cost."""
    if not (grid.requires_grad and torch.is_grad_enabled()):
        return _grid_gather_fwd(grid, cells, plain)
    if bool((cells[:, 1:] < cells[:, :-1]).any()):
        raise ValueError("grid_gather with a gradient needs ascending cell "
                         "ids per sample")
    return _GridGather.apply(grid, cells, plain)


def grid_reduce_add_plain(g: torch.Tensor, cells: torch.Tensor,
                          num_cells: int):
    """g [B, N, C], cells [B, N] (ids >= num_cells, including the int32-max
    pad, are dropped) -> [B, num_cells, C] per-cell sums in g's dtype,
    empty cells 0: `index_add_` into a zeroed fp32 grid with a drop row,
    rounded to g's dtype once."""
    b, _, c = g.shape
    ids = cells.long().clamp(max=num_cells)
    flat = ids + torch.arange(b, device=ids.device)[:, None] * (num_cells + 1)
    out = torch.zeros(b * (num_cells + 1), c, dtype=torch.float32,
                      device=g.device)
    out.index_add_(0, flat.reshape(-1), g.float().reshape(-1, c))
    return out.reshape(b, num_cells + 1, c)[:, :num_cells].to(g.dtype)


def grid_reduce_add(g: torch.Tensor, cells: torch.Tensor, num_cells: int,
                    plain: bool = False):
    """Per-cell sums of cell-sorted point rows (kernel K1-add,
    `kernels/grid_reduce_add.cu`): the `op="add"` of `grid_reduce` at any
    C >= 1. Cell ids MUST be ascending per sample. Same contract as
    `grid_reduce_add_plain`; the kernel sums each cell in fp32, in the
    points' order or, for a cell of more than 32 points, as strided partial
    sums added in a fixed order, and rounds once (the TPU kernel rounds to
    g's dtype after every 128-point chunk)."""
    if kernels.use_plain(g, plain):
        return grid_reduce_add_plain(g, cells, num_cells)
    _check_cuda(g, cells)
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"g must be fp32 or bf16, got {g.dtype}")
    if g.dim() != 3 or cells.shape != g.shape[:2]:
        raise ValueError(f"g {tuple(g.shape)}, cells {tuple(cells.shape)}")
    b, n, c = g.shape
    g = g.contiguous()
    cells = cells.to(torch.int32).contiguous()
    out = torch.empty(b, num_cells, c, dtype=g.dtype, device=g.device)
    kernels.check(
        kernels.function("grid_reduce_add")(
            g.data_ptr(), cells.data_ptr(), out.data_ptr(), b, n, c,
            num_cells, int(g.dtype == torch.bfloat16), kernels.stream(g.device),
        ),
        "grid_reduce_add",
    )
    kernels.launches["grid_reduce_add"] += 1
    return out


def grid_reduce_add_c1_plain(vals: torch.Tensor, bins: torch.Tensor,
                             num_bins: int):
    """vals [R, N] fp32, bins [R, N] int (ids >= num_bins are dropped) ->
    [R, num_bins] fp32 per-bin sums (`index_add_`)."""
    return grid_reduce_add_plain(vals.float()[..., None], bins, num_bins)[..., 0]


def grid_reduce_add_c1(vals: torch.Tensor, bins: torch.Tensor, num_bins: int,
                       plain: bool = False):
    """Per-bin sums of scalar values whose bins are ascending within each
    row (the drop bucket, int32 max, sorts last). Same contract as
    `grid_reduce_add_c1_plain`."""
    if kernels.use_plain(vals, plain):
        return grid_reduce_add_c1_plain(vals, bins, num_bins)
    _check_cuda(vals, bins)
    if vals.dim() != 2 or bins.shape != vals.shape:
        raise ValueError(f"vals {tuple(vals.shape)}, bins {tuple(bins.shape)}")
    r, n = vals.shape
    vals = vals.to(torch.float32).contiguous()
    bins = bins.to(torch.int32).contiguous()
    out = torch.empty((r, num_bins), dtype=torch.float32, device=vals.device)
    kernels.check(
        kernels.function("grid_reduce_add_c1")(
            vals.data_ptr(), bins.data_ptr(), out.data_ptr(), r, n, num_bins,
            kernels.stream(vals.device),
        ),
        "grid_reduce_add_c1",
    )
    kernels.launches["grid_reduce_add_c1"] += 1
    return out
