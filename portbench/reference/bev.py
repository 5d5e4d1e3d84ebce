"""Plain reference: a frozen copy of liso_tpu_torch/ops/bev.py.
It imports nothing of the program; the benchmark compares the program
with it.

The original's docstring:

BEV grid setup (port of liso_tpu/ops/bev.py).

Grid convention: grid is [H, W] with rows <-> x and cols <-> y; the metric
extent is symmetric about the sensor. Voxel centers sit at
(idx + 0.5) * resolution + extent_min.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class BevSetup(NamedTuple):
    bev_range_m: Tuple[float, float]
    grid_size: Tuple[int, int]

    @property
    def res_m(self):
        return (
            self.bev_range_m[0] / self.grid_size[0],
            self.bev_range_m[1] / self.grid_size[1],
        )

    @property
    def extent_min(self):
        return (-0.5 * self.bev_range_m[0], -0.5 * self.bev_range_m[1])

    @property
    def num_cells(self) -> int:
        return self.grid_size[0] * self.grid_size[1]


def voxel_center_coords(setup: BevSetup, device=None) -> torch.Tensor:
    """[H, W, 2] fp32 metric (x, y) of every cell center, computed in float64
    and rounded once, as the JAX package computes it with numpy."""
    h, w = setup.grid_size
    ii, jj = torch.meshgrid(
        torch.arange(h, dtype=torch.float64), torch.arange(w, dtype=torch.float64),
        indexing="ij",
    )
    ij = torch.stack([ii, jj], dim=-1) + 0.5
    res = torch.tensor(setup.res_m, dtype=torch.float64)
    emin = torch.tensor(setup.extent_min, dtype=torch.float64)
    return (ij * res + emin).to(torch.float32).to(device)


def point_cell_ids(
    pts_xy: torch.Tensor, setup: BevSetup, valid: torch.Tensor | None = None
):
    """Map [..., N, 2] metric xy to flat cell id in [0, H*W]; id == H*W is the
    drop bucket for out-of-range or invalid points.

    Returns (cell_id int32 [..., N], in_range bool [..., N],
             rowcol int32 [..., N, 2]).
    """
    h, w = setup.grid_size
    res = torch.tensor(setup.res_m, dtype=pts_xy.dtype, device=pts_xy.device)
    emin = torch.tensor(
        setup.extent_min, dtype=pts_xy.dtype, device=pts_xy.device
    )
    rc = torch.floor((pts_xy - emin) / res).to(torch.int32)
    in_range = (
        (rc[..., 0] >= 0) & (rc[..., 0] < h) & (rc[..., 1] >= 0) & (rc[..., 1] < w)
    )
    if valid is not None:
        in_range = in_range & valid
    rc = torch.stack(
        [rc[..., 0].clamp(0, h - 1), rc[..., 1].clamp(0, w - 1)], dim=-1
    )
    cell = rc[..., 0] * w + rc[..., 1]
    cell = torch.where(in_range, cell, torch.full_like(cell, h * w))
    return cell, in_range, rc


def gather_bev_map_at_points(bev_map: torch.Tensor, pts_xy: torch.Tensor,
                             setup: BevSetup) -> torch.Tensor:
    """Nearest-cell gather of a [H, W, C] map at [..., N, 2] metric points;
    0 for points outside the grid (the reference's grid -> point gather,
    HeadDecoder.apply_flow_to_points)."""
    h, w = setup.grid_size
    cell, in_range, _ = point_cell_ids(pts_xy, setup)
    vals = bev_map.reshape(h * w, -1)[cell.long().clamp(0, h * w - 1)]
    return torch.where(in_range[..., None], vals, 0.0)


def bilinear_sample_2d(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img [H, W, C] at pixel coords [..., 2] (row, col)
    with align_corners=True semantics, clamped at the borders (the
    reference's raft_code/utils.py:bilinear_sampler via grid_sample)."""
    h, w = img.shape[:2]
    r = coords[..., 0].clamp(0.0, h - 1.0)
    c = coords[..., 1].clamp(0.0, w - 1.0)
    r0, c0 = torch.floor(r), torch.floor(c)
    fr, fc = (r - r0)[..., None], (c - c0)[..., None]
    r0, c0 = r0.long(), c0.long()
    r1, c1 = (r0 + 1).clamp(max=h - 1), (c0 + 1).clamp(max=w - 1)
    return (img[r0, c0] * (1 - fr) * (1 - fc)
            + img[r0, c1] * (1 - fr) * fc
            + img[r1, c0] * fr * (1 - fc)
            + img[r1, c1] * fr * fc)
