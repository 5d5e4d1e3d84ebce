"""Plain reference: a frozen copy of liso_tpu_torch/data/centermaps.py.
It imports nothing of the program; the benchmark compares the program
with it.

The original's docstring:

Centermap target rendering: boxes -> gaussian heatmap + regression maps
(port of liso_tpu/data/centermaps.py).

Per-box anisotropic gaussians with covariance 0.3 * 0.5 * diag(l, w)
rotated by yaw, each peak-normalised; the regression maps take, in each
cell the box covers, the attributes of the hottest box there. Boxes whose
heat ties at a cell all paint it, so the cell holds their sum, as the JAX
rendering does (a `heat == max(heat)` mask, not an argmax). Rendering runs
inside the train step on the device: the host ships only box tensors.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench.reference.box_decode import BoxPredictionCfg, prediction_grid_centers
from portbench.reference.bev import BevSetup

OCCUPANCY_THRESH = 0.01


def render_gaussian_heatmaps(boxes: Boxes,
                             centers_xy: torch.Tensor) -> torch.Tensor:
    """Per-slot peak-normalised gaussian [B, K, h, w] at the cell centers
    [h, w, 2]. Invalid slots render zero."""
    sx = 0.3 * 0.5 * boxes.dims[..., 0]
    sy = 0.3 * 0.5 * boxes.dims[..., 1]
    c, s = torch.cos(boxes.rot[..., 0]), torch.sin(boxes.rot[..., 0])
    inv_sx = 1.0 / sx.clamp(min=1e-6)
    inv_sy = 1.0 / sy.clamp(min=1e-6)
    # inverse covariance R diag(1/sx, 1/sy) R^T
    a = c * c * inv_sx + s * s * inv_sy
    b = c * s * (inv_sx - inv_sy)
    d = s * s * inv_sx + c * c * inv_sy
    dx = centers_xy[None, None, ..., 0] - boxes.pos[..., 0, None, None]
    dy = centers_xy[None, None, ..., 1] - boxes.pos[..., 1, None, None]
    quad = (a[..., None, None] * dx * dx
            + 2.0 * b[..., None, None] * dx * dy
            + d[..., None, None] * dy * dy)
    heat = torch.exp(-0.5 * quad)
    peak = heat.amax(dim=(-2, -1), keepdim=True)
    heat = heat / peak.clamp(min=1e-5)
    return heat * boxes.valid[..., None, None]


def render_centermaps(
    boxes: Boxes, bev: BevSetup, grid_hw: Tuple[int, int],
    cfg: BoxPredictionCfg, per_obj_prob_scale: torch.Tensor = None,
) -> Dict[str, torch.Tensor]:
    """Target maps for the centerpoint loss, [B, h, w, C] each, plus
    center_bool_mask [B, h, w] (cells holding a valid box center).
    per_obj_prob_scale [B, K, 1] (shaped as boxes.probs), when given,
    scales each box's heat."""
    dev = boxes.pos.device
    centers = torch.from_numpy(prediction_grid_centers(bev, grid_hw)).to(dev)
    heat = render_gaussian_heatmaps(boxes, centers)  # [B, K, h, w]
    if per_obj_prob_scale is not None:
        heat = heat * per_obj_prob_scale[..., None]
    occ = (heat > OCCUPANCY_THRESH).float()
    hottest = (heat == heat.amax(dim=1, keepdim=True)).float()
    pick = occ * hottest  # [B, K, h, w]

    if cfg.rotation_method == "vector":
        rot_val = torch.cat([torch.sin(boxes.rot), torch.cos(boxes.rot)], -1)
    else:
        rot_val = boxes.rot
    if cfg.dimensions_method == "predict_log_size":
        dims_val = torch.log(boxes.dims.clamp(min=1e-6))
    else:
        dims_val = boxes.dims

    def paint(vals):  # [B, K, C] -> [B, h, w, C]
        return torch.einsum("bkhw,bkc->bhwc", pick, vals)

    velo = boxes.velo if boxes.velo is not None else torch.zeros_like(boxes.probs)
    maps = {
        "probs": heat.amax(dim=1)[..., None],
        "pos": paint(boxes.pos),
        "dims": paint(dims_val),
        "rot": paint(rot_val),
        "velo": paint(velo),
    }

    # center mask: the cell of each valid box center, by a scatter into
    # h * w + 1 cells (the last one takes the centers outside the grid)
    h, w = grid_hw
    res = torch.tensor([bev.bev_range_m[0] / h, bev.bev_range_m[1] / w],
                       dtype=torch.float32, device=dev)
    emin = torch.tensor(bev.extent_min, dtype=torch.float32, device=dev)
    rc = torch.floor((boxes.pos[..., :2] - emin) / res).to(torch.int32)
    in_range = ((rc[..., 0] >= 0) & (rc[..., 0] < h) & (rc[..., 1] >= 0)
                & (rc[..., 1] < w) & boxes.valid)
    cell = torch.where(in_range, rc[..., 0] * w + rc[..., 1], h * w).long()
    hits = torch.zeros(cell.shape[0], h * w + 1, dtype=torch.float32,
                       device=dev)
    hits.scatter_add_(1, cell, torch.ones_like(cell, dtype=torch.float32))
    maps["center_bool_mask"] = (hits[:, : h * w] > 0).reshape(-1, h, w)
    return maps
