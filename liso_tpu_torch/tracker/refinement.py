"""Track post-processing: local box refinement + keep/drop filters (port of
liso_tpu/tracker/refinement.py).

Behavioral reference: liso/tracker/tracking.py:239-261
(set_box_size_keep_closest_point_constant), :2004-2133
(perform_local_box_refinement) and :2214-2259 (decide_keep_or_drop_box).
The per-frame closeness-to-edge fit is the vectorised angle sweep of
tracker/box_fitting.py on `device`; everything else is numpy on
variable-length track arrays.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from liso_tpu_torch.tracker.box_fitting import fit_2d_box
from liso_tpu_torch.tracker.tracker import BoxArr, box_poses


def set_box_size_keep_closest_point_constant(
    boxes: BoxArr, new_dims: np.ndarray
) -> BoxArr:
    """Resize every box to new_dims while keeping its sensor-closest bottom
    corner fixed (tracking.py:239-261) — prevents the refined box from
    swallowing free space on the visible side."""
    out = {k: v.copy() for k, v in boxes.items()}
    k = len(out["pos"])
    if k == 0:
        return out
    yaw = out["rot"][:, 0]
    c, s = np.cos(yaw), np.sin(yaw)
    lx = out["dims"][:, 0] * 0.5
    wy = out["dims"][:, 1] * 0.5
    cx = np.stack([lx, -lx, -lx, lx], -1)
    cy = np.stack([wy, wy, -wy, -wy], -1)
    corner_x = c[:, None] * cx - s[:, None] * cy + out["pos"][:, :1]
    corner_y = s[:, None] * cx + c[:, None] * cy + out["pos"][:, 1:2]
    z_lo = out["pos"][:, 2] - 0.5 * out["dims"][:, 2]
    dist = np.hypot(corner_x, corner_y)
    ci = np.argmin(dist, axis=-1)
    rows = np.arange(k)
    closest = np.stack(
        [corner_x[rows, ci], corner_y[rows, ci], z_lo], axis=-1
    )
    shift = new_dims / np.maximum(out["dims"], 1e-6) * (out["pos"] - closest)
    out["pos"] = (closest + shift).astype(np.float32)
    out["dims"] = np.broadcast_to(
        np.asarray(new_dims, np.float32), out["dims"].shape
    ).copy()
    return out


def refine_track_boxes(
    track_boxes_sensor: BoxArr,  # [T] boxes of ONE track, sensor coords
    pcls_sensor: List[np.ndarray],  # per-frame [Ni, >=3] clouds
    *,
    dims_quantile: float = 0.95,  # 0.95 bootstrap round, 0.6 later rounds
    fit_rot: bool = True,
    fit_pos: bool = True,
    bloat_factor: float = 1.0,
    min_pts: int = 3,
    device=None,
) -> BoxArr:
    """perform_local_box_refinement: quantile-smooth dims over the track,
    per-frame closeness-to-edge re-fit of yaw/center, then resize keeping
    the closest corner fixed. The fits run on `device`."""
    t = len(track_boxes_sensor["pos"])
    assert len(pcls_sensor) == t, (len(pcls_sensor), t)
    refined_dims = np.quantile(track_boxes_sensor["dims"], dims_quantile, axis=0)
    out = {k: v.copy() for k, v in track_boxes_sensor.items()}

    if fit_rot or fit_pos:
        for i in range(t):
            pcl = np.asarray(pcls_sensor[i])[:, :3]
            pose = box_poses({k: v[i : i + 1] for k, v in out.items()})[0]
            inv = np.linalg.inv(pose)
            p_box = pcl @ inv[:3, :3].T + inv[:3, 3]
            inside = np.all(
                np.abs(p_box[:, :2])
                < 0.5 * bloat_factor * out["dims"][i, :2],
                axis=-1,
            )
            if inside.sum() < min_pts:
                continue
            pts = pcl[inside][:, :2]
            center, _, _, yaw = fit_2d_box(
                torch.as_tensor(pts, dtype=torch.float32, device=device),
                torch.ones((len(pts),), dtype=torch.bool, device=device),
                method="closeness_to_edge",
            )
            fit = torch.cat([center, yaw[None]]).cpu().numpy()  # one copy
            if fit_rot:
                out["rot"][i, 0] += float(fit[2]) - out["rot"][i, 0]
            if fit_pos:
                out["pos"][i, :2] = fit[:2]
    return set_box_size_keep_closest_point_constant(out, refined_dims)


def decide_keep_or_drop_track(
    track_boxes_world: BoxArr,
    *,
    min_track_obj_speed_mps: float,
    time_between_frames_s: float,
    is_flow_cluster_detector: bool,
    flow_cluster_min_travel_dist_m: float = 0.5,
) -> Tuple[bool, float]:
    """decide_keep_or_drop_box (tracking.py:2214-2259): speed filter via
    endpoint displacement, plus travel-distance filter for the bootstrap
    flow-cluster detector."""
    coors = track_boxes_world["pos"][:, :2]
    total_dist = float(np.linalg.norm(coors[-1] - coors[0]))
    seq_len = len(coors)
    keep = True
    if min_track_obj_speed_mps > 0.0:
        speed = total_dist / max(seq_len * time_between_frames_s, 1e-6)
        keep = speed >= min_track_obj_speed_mps
    if keep and is_flow_cluster_detector:
        keep = total_dist >= flow_cluster_min_travel_dist_m
    return keep, total_dist
