"""Flow-based box propagation and motion-aligned yaw (port of
liso_tpu/tracker/propagation.py).

Behavioral reference: liso/tracker/tracking.py:2168-2211
(propagate_boxes_forward_using_flow) and liso/kabsch/shape_utils.py:583-645.
One frame's fixed-capacity Boxes; invalid slots propagate with the
identity.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from liso_tpu_torch.ops import transforms as tr
from liso_tpu_torch.ops.boxes import Boxes


def mean_flow_per_box(boxes: Boxes, pcl: torch.Tensor, valid: torch.Tensor,
                      flow: torch.Tensor) -> torch.Tensor:
    """[K, 3] mean flow of the points inside each box
    (tracking.py:2176-2186)."""
    inside = boxes.points_in_box_mask(pcl[..., :3]) & valid[..., None]  # [N, K]
    w = inside.to(torch.float32)
    cnt = w.sum(0).clamp(min=1.0)
    return (w[..., None] * flow[:, None, :]).sum(0) / cnt[:, None]


def propagate_boxes_with_flow(
    boxes: Boxes, pcl: torch.Tensor, valid: torch.Tensor, flow: torch.Tensor,
    odom_ta_tb: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(fg_trafos [K, 4, 4] = I + the mean-flow translation, bg_trafo
    [4, 4] = inv(odom), propagated poses [K, 4, 4] = fg_trafo @
    sensor_T_box, the reference's st1_T_bt1)."""
    mf = mean_flow_per_box(boxes, pcl, valid, flow)
    fg = torch.eye(4, dtype=torch.float32, device=pcl.device).repeat(boxes.k, 1, 1)
    fg[:, :3, 3] = mf
    return fg, tr.invert_pose(odom_ta_tb), fg @ boxes.poses()


def box_motion_without_odometry(boxes: Boxes, fg_trafos: torch.Tensor,
                                bg_trafo: torch.Tensor) -> torch.Tensor:
    """b0_deltaT_b1 = box_T_s0 @ inv(bg) @ fg @ s0_T_box
    (shape_utils.py:583-607): the box's motion without the ego motion, in
    box coordinates."""
    s0_T_b = boxes.poses()
    return (tr.invert_pose(s0_T_b) @ tr.invert_pose(bg_trafo) @ fg_trafos
            @ s0_T_b)


def soft_align_yaw_with_motion(boxes: Boxes, fg_trafos: torch.Tensor,
                               bg_trafo: torch.Tensor,
                               no_align_below_m: float = 0.1,
                               full_align_above_m: float = 0.3) -> Boxes:
    """shape_utils.py:608-645: flip the boxes whose motion points
    backwards, then turn the yaw towards the motion in proportion to the
    displacement; velo = displacement."""
    transl = box_motion_without_odometry(boxes, fg_trafos, bg_trafo)[..., :3, 3]
    disp = torch.linalg.norm(transl[..., :2], dim=-1)
    needs_flip = (transl[..., 0] < 0.0) & (disp > no_align_below_m)
    t2 = torch.where(needs_flip[..., None], -transl[..., :2], transl[..., :2])
    rot = torch.where(needs_flip[..., None], boxes.rot + math.pi, boxes.rot)
    ratio = ((disp - no_align_below_m)
             / (full_align_above_m - no_align_below_m)).clamp(0.0, 1.0)[..., None]
    rot = rot + ratio * torch.atan2(t2[..., 1:2], t2[..., 0:1])
    return boxes.replace(rot=rot, velo=disp[..., None])
