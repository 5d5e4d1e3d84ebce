"""Fixed-shape sample types (port of liso_tpu/data/sample.py): NamedTuples
of tensors, padded to a fixed point count, with validity masks, and the
host-side padding."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from liso_tpu_torch.ops.boxes import Boxes


class PointCloud(NamedTuple):
    pcl: torch.Tensor  # [B, N, 4] x, y, z, intensity
    valid: torch.Tensor  # [B, N] bool


class FlowSample(NamedTuple):
    """One (t0, t1) frame pair for SLIM training. odom_t0_t1 = t0_T_t1 (pose
    of the sensor at t1 expressed in t0)."""

    pcl_t0: PointCloud
    pcl_t1: PointCloud
    odom_t0_t1: torch.Tensor  # [B, 4, 4]
    odom_t1_t0: torch.Tensor  # [B, 4, 4]
    gt_flow_bev_t0_t1: Optional[torch.Tensor] = None  # [B, H, W, 2]
    gt_flow_bev_t1_t0: Optional[torch.Tensor] = None


class DetectionSample(NamedTuple):
    """One frame for detector training (reference 4-tuple element
    sample_data_t0 of lidar_dataset_collate_fn)."""

    pcl: PointCloud
    boxes: Boxes  # mined or GT target boxes
    centermaps: Optional[torch.Tensor] = None  # [B, H, W, C] rendered targets
    centermaps_ignore: Optional[torch.Tensor] = None  # [B, H, W] bool


def pad_points(pts: np.ndarray, n_max: int) -> "tuple[np.ndarray, np.ndarray]":
    """Host-side: pad/trim [N, F] -> ([n_max, F], valid [n_max])."""
    n = min(len(pts), n_max)
    out = np.zeros((n_max, pts.shape[-1]), np.float32)
    out[:n] = pts[:n]
    valid = np.zeros((n_max,), bool)
    valid[:n] = True
    return out, valid
