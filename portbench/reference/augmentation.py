"""Plain reference: a frozen copy of liso_tpu_torch/data/augmentation.py.
It imports nothing of the program; the benchmark compares the program
with it.

The original's docstring:

Data augmentation: global SE(2) jitter + copy-paste box augmentation
(a copy of liso_tpu/data/augmentation.py; numpy only).

Behavioral reference: liso/datasets/torch_dataset_commons.py:1291-1433
(augment_sample_content: rotation <= 90deg, translation <= 5 m, applied
consistently to all pcls / odometries / flows / boxes) and :1531-1786
(create_augmented_sample_from_box_snippet_db: paste 1..max_num_objs mined
object snippets into free BEV space with pose/velocity/scale jitter,
layer-based raydrop and point dropout).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np


class GlobalAugmCfg(NamedTuple):
    max_rot_deg: float = 90.0
    max_sensor_pos_offset_m: float = 5.0


class BoxAugmCfg(NamedTuple):
    max_num_objs: int = 15
    min_artificial_obj_velo: float = 1.0
    max_artificial_obj_velo: float = 3.0
    max_scale_delta: float = 0.2
    max_points_dropout: float = 0.25
    use_raydrop_augm: bool = False
    min_box_len: float = 2.5
    min_box_width: float = 1.5
    min_center_dist_from_occupied_m: float = 2.0


def _se2(theta: float, t_xy: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    c, s = np.cos(theta), np.sin(theta)
    T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
    T[:2, 3] = t_xy
    return T


def augment_sample_content(
    content: dict, rng: np.random.RandomState, cfg: GlobalAugmCfg = GlobalAugmCfg()
) -> dict:
    """Apply one global SE(2) transform T to the whole sample: points p -> T p,
    odometry O -> T O T^-1, flows f -> R f, gt boxes -> T-transformed."""
    theta = np.deg2rad(rng.uniform(-cfg.max_rot_deg, cfg.max_rot_deg))
    t = rng.uniform(-cfg.max_sensor_pos_offset_m, cfg.max_sensor_pos_offset_m, 2)
    T = _se2(theta, t)
    Ti = np.linalg.inv(T)
    R = T[:3, :3]

    out = dict(content)
    for tk in ("t0", "t1", "t2"):
        pk = f"pcl_{tk}"
        if pk in out:
            pcl = np.array(out[pk], np.float32)
            pcl[:, :3] = pcl[:, :3] @ R.T + T[:3, 3]
            out[pk] = pcl
    for k in list(out.keys()):
        if k.startswith("odom_") or k.startswith("kiss_odom_"):
            out[k] = T @ np.asarray(out[k], np.float64) @ Ti
    gt = out.get("gt")
    if isinstance(gt, dict):
        gt = dict(gt)
        for k in list(gt.keys()):
            if k.startswith("flow_"):
                gt[k] = np.asarray(gt[k], np.float32) @ R.T
            if k == "boxes" and isinstance(gt[k], dict):
                boxes = {kk: np.array(vv) for kk, vv in gt[k].items()}
                boxes["pos"] = boxes["pos"] @ R.T + T[:3, 3]
                boxes["rot"] = boxes["rot"] + theta
                gt[k] = boxes
        out["gt"] = gt
    out["_augm_T"] = T
    return out


def resolution_raydrop_augmentation(
    pts_sensor: np.ndarray, rng: np.random.RandomState
) -> np.ndarray:
    """Spherical re-discretization raydrop: re-grid the snippet's points
    onto a random coarser azimuth/elevation raster and keep only every
    drop_ratio-th cell — simulates a lower-resolution sensor.

    Behavioral reference: torch_dataset_commons.py:1786-1804
    (resolution_raydrop_augmentation) — same discretization choices
    (2*pi / {600, 900, 1200, 1500}), same drop ratios {1, 2}, same
    azimuth/elevation index tests."""
    range_m = np.linalg.norm(pts_sensor[:, :3], axis=-1)
    azimuth = np.arctan2(pts_sensor[:, 1], pts_sensor[:, 0])
    elevation = np.arccos(
        np.clip(pts_sensor[:, 2] / np.maximum(1e-5, range_m), -1.0, 1.0)
    )
    resolution = 2.0 * np.pi / rng.choice([600, 900, 1200, 1500])
    azi_idx = (azimuth / resolution).astype(np.int64)
    ele_idx = (elevation / resolution).astype(np.int64)
    drop_ratio = rng.choice([1, 2])
    return ((azi_idx % drop_ratio) == 0) & ((ele_idx % drop_ratio) == 0)


def paste_boxes_into_sample(
    pcl: np.ndarray,  # [N, 4] cropped cloud (will grow)
    rows: np.ndarray,  # [N]
    augm_db: Dict[str, object],  # finalized augm DB (dbs.load_augm_db)
    rng: np.random.RandomState,
    bev_range_m,
    cfg: BoxAugmCfg = BoxAugmCfg(),
    occupied_xy: Optional[np.ndarray] = None,
):
    """Returns (pcl', rows', pasted_boxes dict). Pasted objects keep their
    original range from the sensor (rotated about the origin) so the point
    density stays plausible; raydrop removes random lidar rows
    (layer_based_raydrop_augm)."""
    n_db = len(augm_db["pcl_in_box_cosy"])
    if n_db == 0:
        empty = {
            "pos": np.zeros((0, 3), np.float32),
            "dims": np.zeros((0, 3), np.float32),
            "rot": np.zeros((0, 1), np.float32),
            "probs": np.zeros((0, 1), np.float32),
            "velo": np.zeros((0, 1), np.float32),
        }
        return pcl, rows, empty
    n_objs = rng.randint(1, cfg.max_num_objs + 1)
    idxs = rng.randint(0, n_db, n_objs)
    half = 0.5 * np.asarray(bev_range_m)
    if occupied_xy is None:
        occupied_xy = pcl[:, :2]

    new_pts, new_rows, boxes = [], [], []
    for i in idxs:
        snippet = np.array(augm_db["pcl_in_box_cosy"][i], np.float32)
        lrows = np.asarray(augm_db["lidar_rows"][i])
        box = {k: np.array(v[i], np.float32) for k, v in augm_db["boxes"].items()}
        if box["dims"][0] < cfg.min_box_len or box["dims"][1] < cfg.min_box_width:
            continue

        # rotate original box pose about the sensor by a random yaw
        spin = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(spin), np.sin(spin)
        Rz = np.array([[c, -s], [s, c]], np.float32)
        new_xy = Rz @ box["pos"][:2]
        if np.any(np.abs(new_xy) > half - 1.0):
            continue
        if len(occupied_xy):
            d = np.linalg.norm(occupied_xy - new_xy[None], axis=-1)
            if d.min() < cfg.min_center_dist_from_occupied_m:
                continue

        scale = 1.0 + rng.uniform(-cfg.max_scale_delta, cfg.max_scale_delta)
        yaw = box["rot"][0] + spin
        # snippet points: box coords -> scaled -> new sensor pose
        pts_box = snippet[:, :3] * scale
        cy, sy = np.cos(yaw), np.sin(yaw)
        Rb = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], np.float32)
        pts_sensor = pts_box @ Rb.T
        pts_sensor[:, :2] += new_xy
        pts_sensor[:, 2] += box["pos"][2]
        pts4 = np.concatenate([pts_sensor, snippet[:, 3:4]], axis=-1)
        keep = np.ones(len(pts4), bool)
        if cfg.use_raydrop_augm and len(np.unique(lrows)) > 2:
            drop_rows = rng.choice(
                np.unique(lrows),
                size=max(1, int(len(np.unique(lrows)) * rng.uniform(0, 0.3))),
                replace=False,
            )
            keep &= ~np.isin(lrows, drop_rows)
        if cfg.use_raydrop_augm:
            # second raydrop stage (torch_dataset_commons.py:1623): spherical
            # re-discretization on the sensor-frame snippet; skipped when it
            # would drop every point (reference's count_nonzero guard)
            res_keep = resolution_raydrop_augmentation(pts4, rng)
            if np.count_nonzero(keep & res_keep) > 0:
                keep &= res_keep
        if cfg.max_points_dropout > 0:
            keep &= rng.rand(len(pts4)) > rng.uniform(0, cfg.max_points_dropout)
        if keep.sum() < 5:
            continue
        new_pts.append(pts4[keep])
        new_rows.append(lrows[keep])
        velo = rng.uniform(cfg.min_artificial_obj_velo, cfg.max_artificial_obj_velo)
        boxes.append(
            {
                "pos": np.array([new_xy[0], new_xy[1], box["pos"][2]], np.float32),
                "dims": box["dims"] * scale,
                "rot": np.array([yaw], np.float32),
                "probs": np.ones(1, np.float32),
                "velo": np.array([velo], np.float32),
            }
        )
        occupied_xy = np.concatenate([occupied_xy, new_xy[None]])

    if not boxes:
        empty = {
            "pos": np.zeros((0, 3), np.float32),
            "dims": np.zeros((0, 3), np.float32),
            "rot": np.zeros((0, 1), np.float32),
            "probs": np.zeros((0, 1), np.float32),
            "velo": np.zeros((0, 1), np.float32),
        }
        return pcl, rows, empty
    pcl_out = np.concatenate([pcl] + new_pts)
    rows_out = np.concatenate([rows] + new_rows)
    boxes_out = {
        k: np.stack([b[k] for b in boxes]) for k in boxes[0]
    }
    return pcl_out, rows_out, boxes_out
