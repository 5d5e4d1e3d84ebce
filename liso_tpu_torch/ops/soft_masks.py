"""Soft (differentiable) box-membership masks (port of
liso_tpu/ops/soft_masks.py).

Behavioral reference: liso/kabsch/kabsch_mask.py:26-231. Per box, the
weight of a point is the product over the three axes of
softness(slope * (half_dim - |coord_in_box|)), at points or BEV cell
centers.
"""
from __future__ import annotations

import math

import torch

from liso_tpu_torch.ops import transforms as tr
from liso_tpu_torch.ops.boxes import Boxes


def cauchy(logits: torch.Tensor) -> torch.Tensor:
    """kabsch_mask.py:26-28."""
    return 0.5 + torch.atan(logits) / math.pi


SOFTNESS = {"cauchy": cauchy, "sigmoid": torch.sigmoid}


def soft_box_membership(boxes: Boxes, pts: torch.Tensor,
                        sigmoid_slope: float = 7.0,
                        softness_fun: str = "cauchy") -> torch.Tensor:
    """[..., N, K] soft membership of each point [..., N, 3] in each box
    slot; invalid slots give 0."""
    fn = SOFTNESS[softness_fun]
    box_T_s = tr.invert_pose(boxes.poses())  # [..., K, 4, 4]
    p_box = (torch.einsum("...kij,...nj->...nki", box_T_s[..., :3, :3],
                          pts[..., :3])
             + box_T_s[..., None, :, :3, 3])  # [..., N, K, 3]
    half = 0.5 * boxes.dims[..., None, :, :]
    logits = sigmoid_slope * (half - p_box.abs())
    w = fn(logits[..., 0]) * fn(logits[..., 1]) * fn(logits[..., 2])
    return w * boxes.valid[..., None, :]
