"""Small parity utilities (port of liso_tpu/utils/misc.py: the rotation
regularizers in torch, the rest copied).

Behavioral references:
  * sanity_check_flow — liso/kabsch/main_utils.py:506-551 (validate loaded
    SLIM flow against GT flow before training);
  * rotation regularizers — main_utils.py:51-60 (rot-vec-on-unit-circle)
    and the direct-angle pi limiter (:115-146);
  * CloudLoaderSaver — liso/utils/cloud_utils.py:6-35 (filesystem load/save
    indirection for sample IO);
  * build_augmentation_db_from_actual_groundtruth —
    liso/datasets/create_gt_augm_database.py:38 (GT-based copy-paste DB).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from liso_tpu_torch.eval.flow_metrics import FlowMetrics


def sanity_check_flow(dataset, flow_source_key: str = "flow_t0_t1",
                      max_num_samples: int = 100) -> Dict[str, float]:
    """Compare the flow that training will consume against GT flow; returns
    the FlowMetrics summary (reference logs it to TB before training)."""
    fm = FlowMetrics()
    for idx in range(min(len(dataset), max_num_samples)):
        s = dataset[idx]
        v = s.frame_t0.valid
        flow = s.flow_t0_t1[v]
        # GT flow via rigid ego motion (static assumption) as reference
        pts = s.frame_t0.pcl[v][:, :3]
        inv = np.linalg.inv(np.asarray(s.odom_t0_t1, np.float64))
        gt_static = (pts @ inv[:3, :3].T + inv[:3, 3] - pts).astype(np.float32)
        moving = np.linalg.norm(flow - gt_static, axis=-1) > 0.05
        fm.update(pts, flow, flow, moving, np.ones(len(pts), bool))
    return fm.compute()


def rotation_vec_on_unit_circle_loss(raw_rot: torch.Tensor) -> torch.Tensor:
    """MSE between |rot vector| and 1 (main_utils.py:51-60)."""
    if raw_rot.shape[-1] != 2:
        raise ValueError(f"rotation vectors of shape {tuple(raw_rot.shape)}")
    return ((torch.linalg.vector_norm(raw_rot, dim=-1) - 1.0) ** 2).mean()


def limit_rotation_to_plusminus_half_pi_loss(rot: torch.Tensor) -> torch.Tensor:
    """Penalise |yaw| beyond pi/2 (direct rotation regulariser)."""
    excess = (rot.abs() - torch.pi / 2).clamp(min=0.0)
    return (excess**2).mean()


class CloudLoaderSaver:
    """Filesystem indirection for sample IO (utils/cloud_utils.py:6-35):
    single override point for remote storage backends."""

    def load_sample(self, path, loader=np.load, **kw):
        return loader(Path(path), **kw)

    def save_sample(self, path, obj, saver=np.save, **kw):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        return saver(Path(path), obj, **kw)


def build_augmentation_db_from_groundtruth(
    dataset, max_samples: Optional[int] = None
) -> Dict[str, list]:
    """GT-based copy-paste DB (create_gt_augm_database.py:38): snippets of
    points inside GT boxes, in box coordinates."""
    from liso_tpu_torch.tracker.dbs import empty_augm_db

    db = empty_augm_db()
    track_id = 0
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    for idx in range(n):
        s = dataset[idx]
        if s.gt_boxes is None:
            continue
        pcl = s.frame_t0.pcl[s.frame_t0.valid]
        rows = s.frame_t0.rows[s.frame_t0.valid]
        gb = s.gt_boxes
        for k in range(len(gb["pos"])):
            if not gb["valid"][k]:
                continue
            yaw = gb["rot"][k, 0]
            c, sn = np.cos(yaw), np.sin(yaw)
            R = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]], np.float32)
            p_box = (pcl[:, :3] - gb["pos"][k]) @ R
            inside = np.all(np.abs(p_box) <= 0.55 * gb["dims"][k], axis=-1)
            if inside.sum() < 10:
                continue
            snippet = np.concatenate(
                [p_box[inside], pcl[inside][:, -1:]], -1
            ).astype(np.float32)
            db["pcl_in_box_cosy"].append(snippet)
            db["lidar_rows"].append(rows[inside])
            db["boxes"].append(
                {
                    "pos": gb["pos"][k],
                    "dims": gb["dims"][k],
                    "rot": gb["rot"][k],
                    "probs": np.ones(1, np.float32),
                    "velo": gb.get("velo", np.zeros((len(gb["pos"]), 1)))[k],
                }
            )
            T = np.eye(4)
            T[:3, :3] = R.T
            T[:3, 3] = gb["pos"][k]
            db["box_T_sensor"].append(np.linalg.inv(T))
            db["unique_track_id"].append(track_id)
            track_id += 1
    return db
