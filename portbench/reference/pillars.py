"""Plain reference: a frozen copy of liso_tpu_torch/ops/pillars.py.
It imports nothing of the program; the benchmark compares the program
with it.

The original's docstring:

Fixed-capacity pillarization (port of liso_tpu/ops/pillars.py).

Feature layout of `pillar_point_features` matches mmdet3d PillarFeatureNet
(with_distance=False):
  raw point features [x, y, z, (intensity...)] ++
  cluster offsets    [x - xm, y - ym, z - zm]   (pillar mean)   ++
  center offsets     [x - xc, y - yc]           (pillar center)
"""
from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference import scatter
from portbench.reference.bev import BevSetup, point_cell_ids


def pillarize(
    points: torch.Tensor,
    valid: torch.Tensor,
    setup: BevSetup,
    z_cutoff: float = 5.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """points [..., N, >=3], valid [..., N] -> (cell_id [..., N] in
    [0, H*W], in_pillar [..., N]). Points with |z| >= z_cutoff go to the
    drop bucket."""
    z_ok = points[..., 2].abs() < z_cutoff
    cell_id, in_range, _ = point_cell_ids(points[..., :2], setup, valid & z_ok)
    return cell_id, in_range


def pillar_point_features(points: torch.Tensor, cell_id: torch.Tensor,
                          in_pillar: torch.Tensor,
                          setup: BevSetup) -> torch.Tensor:
    """The augmented per-point features [N, F + 5] of points [N, F >= 3]
    (xyz + optional intensity channels); 0 outside a pillar."""
    xyz = points[..., :3]
    mean_xyz, _ = scatter.scatter_mean_grid(xyz, cell_id, setup.num_cells)
    cluster_off = xyz - scatter.gather_grid(mean_xyz, cell_id)
    h, w = setup.grid_size
    kw = dict(dtype=points.dtype, device=points.device)
    res = torch.tensor(setup.res_m, **kw)
    emin = torch.tensor(setup.extent_min, **kw)
    cid = cell_id.long()
    rc = torch.stack([cid // w, cid % w], dim=-1).to(points.dtype)
    center_off = points[..., :2] - ((rc + 0.5) * res + emin)
    feats = torch.cat([points, cluster_off, center_off], dim=-1)
    return torch.where(in_pillar[..., None], feats, 0.0)


def scatter_pillars_to_bev(point_feats: torch.Tensor, cell_id: torch.Tensor,
                           setup: BevSetup) -> torch.Tensor:
    """Per-point encoded features [N, C] -> dense BEV image [H, W, C] by the
    per-pillar max (PillarFeatureNet's max pooling and PointPillarsScatter
    in one); empty pillars are 0."""
    h, w = setup.grid_size
    grid = scatter.scatter_max_grid(point_feats, cell_id, setup.num_cells,
                                    fill=0.0)
    return grid.reshape(h, w, point_feats.shape[-1])


def occupancy_map(cell_id: torch.Tensor, in_pillar: torch.Tensor,
                  setup: BevSetup) -> torch.Tensor:
    """[H, W, 1] pillar occupancy (the reference's filled_pillar_mask,
    pcl_to_feature_grid.py:52-54)."""
    h, w = setup.grid_size
    occ = scatter.scatter_add_grid(in_pillar.to(torch.float32), cell_id,
                                   setup.num_cells)
    return (occ > 0).to(torch.float32).reshape(h, w, 1)
