"""Plain reference: a frozen copy of liso_tpu_torch/ops/scatter.py.
It imports nothing of the program; the benchmark compares the program
with it.

The original's docstring:

Scatter ops onto BEV grids and segment reductions over cell-sorted
points (port of liso_tpu/ops/scatter.py). Ids equal to `num_cells` are the
drop bucket.
"""
from __future__ import annotations

import torch


def scatter_add_grid(values: torch.Tensor, cell_id: torch.Tensor,
                     num_cells: int) -> torch.Tensor:
    """values [N, C] or [N], cell_id [N] in [0, num_cells] (num_cells is
    the drop bucket) -> per-cell sums [num_cells, C] or [num_cells]. In JAX
    an XLA segment_sum, not a Pallas kernel: here index_add_."""
    out = values.new_zeros((num_cells + 1,) + tuple(values.shape[1:]))
    out.index_add_(0, cell_id.long(), values)
    return out[:num_cells]


def scatter_mean_grid(values: torch.Tensor, cell_id: torch.Tensor,
                      num_cells: int, eps: float = 1e-8):
    """Per-cell means and point counts: (sum / max(count, eps), count),
    counts [num_cells, 1] for 2-D values, else [num_cells]."""
    s = scatter_add_grid(values, cell_id, num_cells)
    cnt = scatter_add_grid(torch.ones(cell_id.shape, dtype=torch.float32,
                                      device=cell_id.device),
                           cell_id, num_cells)
    if values.dim() == 2:
        cnt = cnt[:, None]
    return s / cnt.clamp(min=eps), cnt


def sorted_segment_totals(values: torch.Tensor, cells: torch.Tensor):
    """Per-point segment total for cell-sorted points: values [B, N, C],
    cells [B, N] ascending -> [B, N, C] where every point carries the sum
    over its whole segment.

    Computed as a difference of float64 prefix sums taken at each segment's
    ends: deterministic on the card (no atomics) and, in float64, free of
    the cancellation an fp32 prefix sum over 32k points would suffer. The
    scan runs over the innermost dim of a [B, C, N] copy: PyTorch's CUDA
    scan over a middle dim walks each of the B*C columns in one thread.
    """
    b, n, c = values.shape
    prefix = torch.cumsum(values.to(torch.float64).transpose(1, 2), dim=-1)
    prefix = torch.cat([prefix.new_zeros(b, c, 1), prefix], dim=-1)  # [B,C,N+1]
    bounds = cells.contiguous()
    # segment of point i spans [first, end): first = searchsorted left,
    # end = searchsorted right
    first = torch.searchsorted(bounds, bounds, right=False)
    end = torch.searchsorted(bounds, bounds, right=True)
    hi = torch.gather(prefix, 2, end.unsqueeze(1).expand(b, c, n))
    lo = torch.gather(prefix, 2, first.unsqueeze(1).expand(b, c, n))
    return (hi - lo).transpose(1, 2).to(values.dtype)


def scatter_max_grid(
    values: torch.Tensor, cell_id: torch.Tensor, num_cells: int,
    fill: float = 0.0,
):
    """values [..., N, C], cell_id [..., N] with ids >= num_cells in the
    drop bucket -> [..., num_cells, C] per-cell max, `fill` in empty
    cells."""
    c = values.shape[-1]
    idx = cell_id.long().clamp(max=num_cells).unsqueeze(-1)
    idx = idx.expand(*cell_id.shape, c)
    out = values.new_full((*values.shape[:-2], num_cells + 1, c), fill)
    out.scatter_reduce_(-2, idx, values, "amax", include_self=False)
    return out[..., :num_cells, :]


def gather_grid(grid: torch.Tensor, cell_id: torch.Tensor) -> torch.Tensor:
    """grid [num_cells, C], cell_id [N] -> [N, C], the per-point gather of
    BEV features (the inverse of the scatters). Drop-bucket ids are
    clamped to the last cell, not zeroed: the caller masks."""
    return grid[cell_id.long().clamp(0, grid.shape[0] - 1)]
