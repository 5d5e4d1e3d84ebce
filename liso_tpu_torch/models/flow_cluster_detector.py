"""Flow-cluster bootstrap detector: scene flow -> initial boxes (port of
liso_tpu/models/flow_cluster_detector.py).

Behavioral reference: liso/networks/flow_cluster_detector/
flow_cluster_detector.py:14-384 and liso/utils/bev_flow_utils.py:6-77.
Round 0 of LISO's self-training: non-rigid BEV flow, thresholded at
time_delta * 1 m/s, clustered (connected components of the dilated mask,
ops/clustering.py), a rectangle from each cluster's moments, z and height
from the points inside, size and aspect filters, and the yaw turned to the
Kabsch motion direction. Every slot of the k_max boxes is computed on the
device; the per-box Kabsch runs batched over the slots.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from liso_tpu_torch.ops import kabsch as kab
from liso_tpu_torch.ops import transforms as tr
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.ops.clustering import cluster_stats, connected_components
from liso_tpu_torch.ops.scatter import scatter_add_grid


class FlowClusterCfg(NamedTuple):
    min_num_pts_per_box: int = 10
    max_box_len_m: float = 7.0
    aspect_ratio_max: float = 4.0
    min_box_area_m2: float = 0.35  # pedestrian footprint
    min_box_volume_m3: float = 0.5  # pedestrian volume
    min_residual_flow_thresh_mps: float = 1.0
    k_max: int = 64
    dilation: int = 2


def bev_dynamicness_and_flow(pcl, valid, cell_id, point_flow, odom_ta_tb,
                             bev: BevSetup):
    """Non-rigid flow (flow less the ego motion's rigid flow) and its
    length, scatter-averaged onto the BEV grid: ([H, W], [H, W, 3])
    (bev_flow_utils.get_bev_dynamic_flow_map_from_pcl_flow_and_odom)."""
    h, w = bev.grid_size
    inv = tr.invert_pose(odom_ta_tb)
    pts = torch.where(valid[..., None], pcl[..., :3], 0.0)
    rigid = tr.transform_points(inv[None], pts[None])[0] - pts
    nonrigid = torch.where(valid[..., None], point_flow - rigid, 0.0)
    res_len = torch.linalg.norm(nonrigid, dim=-1)
    cnt = scatter_add_grid(valid.to(torch.float32), cell_id, bev.num_cells)
    dyn = scatter_add_grid(torch.where(valid, res_len, 0.0), cell_id,
                           bev.num_cells)
    flow_sum = scatter_add_grid(nonrigid, cell_id, bev.num_cells)
    denom = cnt.clamp(min=1.0)
    return (dyn / denom).reshape(h, w), (flow_sum / denom[:, None]).reshape(h, w, 3)


def fit_z_and_height(pcl_full, valid, boxes: Boxes,
                     probe_height: float = 1000.0):
    """Points in each box's (height-unbounded) footprint; box z = the
    lowest point + half the height clipped to [1, 2] m
    (fit_bev_box_z_and_height_using_points_in_box). Returns (points per
    box [K], box z [K], height [K])."""
    probe = boxes.replace(dims=torch.cat(
        [boxes.dims[..., :2], torch.full_like(boxes.dims[..., :1], probe_height)],
        -1))
    inside = probe.points_in_box_mask(pcl_full[..., :3]) & valid[..., None]
    box_T_sensor = tr.invert_pose(boxes.poses())
    z_in_box = (torch.einsum("kj,nj->nk", box_T_sensor[..., 2, :3],
                             pcl_full[..., :3])
                + box_T_sensor[..., 2, 3][None])
    z_max = torch.where(inside, z_in_box, -probe_height).amax(0)
    z_low = torch.where(inside, z_in_box, probe_height)
    z_min = z_low.amin(0)
    height = (z_max - z_min).clamp(1.0, 2.0)
    min_idx = torch.argmin(z_low, dim=0)  # first index of the minimum
    box_z = pcl_full[min_idx, 2] + 0.5 * height
    return inside.sum(0), box_z, height


def detect_boxes_from_flow(pcl, valid, cell_id, point_flow, odom_ta_tb,
                           pcl_full, pcl_full_valid, time_delta_s,
                           bev: BevSetup,
                           cfg: FlowClusterCfg = FlowClusterCfg()) -> Boxes:
    """One frame's bootstrap boxes, k_max slots. pcl [N, >=3] is the
    BEV-cropped cloud without ground, valid [N], cell_id [N] its BEV cells,
    point_flow [N, 3] its flow ta -> tb, odom_ta_tb [4, 4]; pcl_full [M, >=3]
    with its validity is the cloud the z fit reads."""
    dyn, _ = bev_dynamicness_and_flow(pcl, valid, cell_id, point_flow,
                                      odom_ta_tb, bev)
    mask = dyn > time_delta_s * cfg.min_residual_flow_thresh_mps
    labels = connected_components(mask, dilation=cfg.dilation)
    stats = cluster_stats(labels, k_max=cfg.k_max)

    dev = pcl.device
    res = torch.tensor(bev.res_m, dtype=torch.float32, device=dev)
    emin = torch.tensor(bev.extent_min, dtype=torch.float32, device=dev)
    center_xy = (stats.centroid_rc + 0.5) * res + emin
    dims2 = torch.stack([stats.axis_major, stats.axis_minor], -1) * res.mean()
    boxes = Boxes(
        pos=torch.cat([center_xy, torch.zeros_like(center_xy[..., :1])], -1),
        dims=torch.cat([dims2, torch.ones_like(dims2[..., :1])], -1),
        rot=stats.orientation[..., None],
        probs=torch.ones_like(stats.orientation[..., None]),
        valid=stats.valid,
    ).with_defaults()

    n_pts, box_z, height = fit_z_and_height(pcl_full, pcl_full_valid, boxes)
    boxes = boxes.replace(
        pos=torch.cat([boxes.pos[..., :2], box_z[..., None]], -1),
        dims=torch.cat([boxes.dims[..., :2], height[..., None]], -1),
    )
    aspect = boxes.dims[..., 0] / boxes.dims[..., 1].clamp(min=1e-3)
    keep = (
        boxes.valid
        & (n_pts >= cfg.min_num_pts_per_box)
        & (aspect <= cfg.aspect_ratio_max)
        & (boxes.dims[..., 0] <= cfg.max_box_len_m)
        & (torch.prod(boxes.dims[..., :2], -1) > cfg.min_box_area_m2)
        & (torch.prod(boxes.dims, -1) > cfg.min_box_volume_m3)
    )
    boxes = boxes.replace(valid=keep)

    # yaw turned to the Kabsch motion direction, speed as velo
    # (flow_cluster_detector.py:310-336)
    member = boxes.points_in_box_mask(pcl[..., :3]) & valid[..., None]  # [N, K]
    wts = member.to(torch.float32).T  # [K, N]
    fg_trafos, _ = kab.kabsch_from_flow(pcl[None, :, :3], point_flow[None], wts)
    bg_w = (valid & ~member.any(-1)).to(torch.float32)
    bg_trafo, _ = kab.kabsch_from_flow(pcl[:, :3], point_flow, bg_w)
    # the box center's motion relative to the background, in box coords
    centers_h = torch.cat([boxes.pos, torch.ones_like(boxes.pos[..., :1])], -1)
    moved = torch.einsum("kij,kj->ki", fg_trafos[:, :3, :], centers_h)
    bg_moved = torch.einsum("ij,kj->ki", bg_trafo[:3, :], centers_h)
    translation = moved - bg_moved  # [K, 3] sensor frame
    c, s = torch.cos(boxes.rot[..., 0]), torch.sin(boxes.rot[..., 0])
    tx = c * translation[..., 0] + s * translation[..., 1]
    ty = -s * translation[..., 0] + c * translation[..., 1]
    speed = torch.linalg.norm(translation[..., :2], dim=-1)
    boxes = boxes.replace(rot=boxes.rot + torch.atan2(ty, tx)[..., None],
                          velo=speed[..., None])
    return boxes.mask_invalid()
