"""Fixed-shape sample types (port of liso_tpu/data/sample.py's PointCloud
and FlowSample): NamedTuples of tensors, padded to a fixed point count,
with validity masks."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


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

