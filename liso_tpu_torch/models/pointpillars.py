"""PointPillars detector with an anchor head (port of
liso_tpu/models/pointpillars.py).

  * the pillar encoder, the three-stage RPN (`second_fpn`, the SECOND +
    FPN topology) and a 3x3 `reduce` ConvBNRelu to 128 channels;
  * A = sizes x rotations anchors per cell, 1x1 conv cls / reg / dir heads,
    the SECOND delta encoding (dx, dy over the anchor's diagonal, dz over
    its height, log dims, dyaw);
  * MaxIoUAssigner targets from the rotated BEV IoU of every anchor with
    every GT slot: positive >= 0.6, negative < 0.45, ignored between, and
    the best anchor of every valid GT forced positive;
  * focal cls + smooth-L1 on the deltas (sin-difference yaw) + direction CE.

The assignment carries no gradient (JAX differentiates nothing through
it) and runs outside autograd. Its IoU is the largest tensor of the step:
at grid 512 the head grid is 128^2, so 131072 anchors against every GT
slot. Only pairs whose circumscribed circles meet can overlap; the IoU of
those pairs is computed (`anchor_gt_iou`) and every other pair is 0, as it
is in the dense matrix. The force-match scatters only the valid GT rows:
the reference scatters every row, and a padded row (whose best anchor is
anchor 0) writes False to anchor 0 after a valid GT may have set it
(liso_tpu/models/pointpillars.py:157-158).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from liso_tpu_torch.models.centerpoint import RPN, ConvBNRelu
from liso_tpu_torch.models.layers import Conv
from liso_tpu_torch.models.pillar_encoder import PillarEncoder
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.ops.iou import EPS, rotated_intersection_area

# class-agnostic "movable" anchors: car / van / pedestrian / cyclist sized
ANCHOR_SIZES = (
    (3.9, 1.6, 1.56),
    (5.2, 2.0, 2.0),
    (0.8, 0.6, 1.73),
    (1.76, 0.6, 1.73),
)
ANCHOR_ROTATIONS = (0.0, np.pi / 2)
ANCHOR_Z = -1.0
# pairs whose centers lie further apart than their circumscribed radii
# plus this margin cannot share a point (the IoU's edge tests allow 1e-8)
_PAIR_MARGIN = 1e-3


class AnchorCfg(NamedTuple):
    sizes: Tuple = ANCHOR_SIZES
    rotations: Tuple = ANCHOR_ROTATIONS
    pos_iou: float = 0.6
    neg_iou: float = 0.45

    @property
    def num_anchors(self):
        return len(self.sizes) * len(self.rotations)


def make_anchors(bev: BevSetup, grid_hw, cfg: AnchorCfg) -> np.ndarray:
    """[h, w, A, 7] (x, y, z, l, w, h, yaw)."""
    h, w = grid_hw
    res = (bev.bev_range_m[0] / h, bev.bev_range_m[1] / w)
    ij = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), -1) + 0.5
    centers = ij * np.array(res) + np.array(bev.extent_min)  # [h, w, 2]
    anchors = []
    for size in cfg.sizes:
        for rot in cfg.rotations:
            a = np.zeros((h, w, 7), np.float32)
            a[..., :2] = centers
            a[..., 2] = ANCHOR_Z
            a[..., 3:6] = size
            a[..., 6] = rot
            anchors.append(a)
    return np.stack(anchors, axis=2)


def encode_deltas(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """The SECOND box encoding: gt [..., 7] against anchors -> deltas."""
    diag = torch.sqrt(anchors[..., 3] ** 2 + anchors[..., 4] ** 2)
    return torch.stack(
        [
            (gt[..., 0] - anchors[..., 0]) / diag,
            (gt[..., 1] - anchors[..., 1]) / diag,
            (gt[..., 2] - anchors[..., 2]) / anchors[..., 5].clamp(min=1e-3),
            torch.log((gt[..., 3] / anchors[..., 3]).clamp(min=1e-3)),
            torch.log((gt[..., 4] / anchors[..., 4]).clamp(min=1e-3)),
            torch.log((gt[..., 5] / anchors[..., 5]).clamp(min=1e-3)),
            gt[..., 6] - anchors[..., 6],
        ],
        dim=-1,
    )


def decode_deltas(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    diag = torch.sqrt(anchors[..., 3] ** 2 + anchors[..., 4] ** 2)
    return torch.stack(
        [
            deltas[..., 0] * diag + anchors[..., 0],
            deltas[..., 1] * diag + anchors[..., 1],
            deltas[..., 2] * anchors[..., 5] + anchors[..., 2],
            torch.exp(deltas[..., 3].clamp(-4, 4)) * anchors[..., 3],
            torch.exp(deltas[..., 4].clamp(-4, 4)) * anchors[..., 4],
            torch.exp(deltas[..., 5].clamp(-4, 4)) * anchors[..., 5],
            deltas[..., 6] + anchors[..., 6],
        ],
        dim=-1,
    )


class PointPillarsNet(nn.Module):
    """Returns (cls [B, h, w, A], reg [B, h, w, A, 7], dir [B, h, w, A, 2],
    occupancy)."""

    def __init__(self, bev: BevSetup, anchor_cfg: AnchorCfg = AnchorCfg(),
                 hid_dim: int = 64, point_features: int = 4, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.anchor_cfg = anchor_cfg
        a = anchor_cfg.num_anchors
        self.pfn = PillarEncoder(bev, num_channels=hid_dim,
                                 point_features=point_features,
                                 scatter_dtype=dtype, device=device)
        self.second_fpn = RPN(hid_dim, **kw)
        self.reduce = ConvBNRelu(self.second_fpn.out_channels, 128, 1, **kw)
        self.cls_head = Conv(128, a, 1, **kw)
        self.reg_head = Conv(128, a * 7, 1, **kw)
        self.dir_head = Conv(128, a * 2, 1, **kw)

    def forward(self, points, valid):
        img, occ = self.pfn(points, valid)
        feat = self.reduce(self.second_fpn(img.permute(0, 3, 1, 2)))
        a = self.anchor_cfg.num_anchors
        heads = [getattr(self, n)(feat).float().permute(0, 2, 3, 1)
                 for n in ("cls_head", "reg_head", "dir_head")]
        b, h, w, _ = heads[0].shape
        return (heads[0].reshape(b, h, w, a), heads[1].reshape(b, h, w, a, 7),
                heads[2].reshape(b, h, w, a, 2), occ)


def anchor_gt_iou(anchors: torch.Tensor, gt: Boxes) -> torch.Tensor:
    """Rotated BEV IoU [B, N, K] of anchors [N, 7] with gt [B, K] (invalid
    GT columns 0): ops.iou.iou_matrix_bev's values, computed only for the
    pairs whose circumscribed circles meet (every other pair reads 0 in the
    dense matrix too). One host sync, for the pair count."""
    a5 = torch.cat([anchors[:, :2], anchors[:, 3:5], anchors[:, 6:7]], -1)
    g5 = torch.cat([gt.pos[..., :2], gt.dims[..., :2], gt.rot[..., :1]], -1)
    r_a = 0.5 * torch.linalg.norm(anchors[:, 3:5], dim=-1)  # [N]
    r_g = 0.5 * torch.linalg.norm(gt.dims[..., :2], dim=-1)  # [B, K]
    d = torch.linalg.norm(anchors[None, :, None, :2] - gt.pos[:, None, :, :2],
                          dim=-1)  # [B, N, K]
    near = (d <= r_a[None, :, None] + r_g[:, None, :] + _PAIR_MARGIN) & (
        gt.valid[:, None, :])
    bi, ni, ki = torch.nonzero(near, as_tuple=True)
    inter = rotated_intersection_area(a5[ni], g5[bi, ki])
    area_a = anchors[ni, 3] * anchors[ni, 4]
    area_g = gt.dims[bi, ki, 0] * gt.dims[bi, ki, 1]
    iou = torch.zeros(near.shape, dtype=a5.dtype, device=a5.device)
    iou[bi, ni, ki] = inter / (area_a + area_g - inter).clamp(min=EPS)
    return iou


@torch.no_grad()
def assign_targets(gt: Boxes, anchors: torch.Tensor, cfg: AnchorCfg):
    """MaxIoUAssigner over a batch: gt [B, K], anchors [N, 7] ->
    (labels [B, N] in {1 pos, 0 neg, -1 ignore}, matched GT slot [B, N])."""
    iou = anchor_gt_iou(anchors, gt)
    # argmax takes the first of tied maxima, as jnp.argmax does (most
    # anchors meet no GT: their row is all 0 and they take slot 0)
    best_iou, best_gt = iou.amax(dim=2), iou.argmax(dim=2)
    labels = torch.where(best_iou >= cfg.pos_iou, 1,
                         torch.where(best_iou < cfg.neg_iou, 0, -1))
    # force-match: the best anchor of every VALID GT becomes positive
    best_anchor = iou.argmax(dim=1)  # [B, K]
    to = torch.where(gt.valid, best_anchor, iou.shape[1])
    force = torch.zeros(iou.shape[0], iou.shape[1] + 1, dtype=torch.bool,
                        device=iou.device).scatter_(1, to, True)[:, :-1]
    labels = torch.where(force, 1, labels)
    best_gt = torch.where(force, (force[..., None] * iou).argmax(dim=2), best_gt)
    return labels, best_gt


def pointpillars_loss(cls_logits, reg, direction, anchors, gt: Boxes,
                      cfg: AnchorCfg):
    """Per-sample losses [B] of flat heads cls [B, N], reg [B, N, 7],
    direction [B, N, 2] (mmdet3d Anchor3DHead semantics): focal cls
    (alpha 0.25, gamma 2), smooth-L1 deltas with the sin-difference yaw, and
    the direction CE x0.2, each over the sample's positives."""
    labels, gt_idx = assign_targets(gt, anchors, cfg)
    pos = labels == 1
    num_pos = pos.sum(-1).clamp(min=1)

    p = torch.sigmoid(cls_logits)
    alpha, gamma = 0.25, 2.0
    pt = torch.where(pos, p, 1 - p)
    alpha_t = torch.where(pos, alpha, 1 - alpha)
    ce = -torch.log(pt.clamp(1e-7, 1.0))
    focal = alpha_t * (1 - pt) ** gamma * ce
    cls_loss = torch.where(labels >= 0, focal, 0.0).sum(-1) / num_pos

    g = gt.with_defaults()
    gt7 = torch.cat([g.pos, g.dims, g.rot], dim=-1)  # [B, K, 7]
    matched = torch.gather(gt7, 1, gt_idx[..., None].expand(-1, -1, 7))
    t = encode_deltas(matched, anchors[None])
    t = torch.cat([t[..., :6], torch.sin(t[..., 6:7])], -1)
    r = torch.cat([reg[..., :6], torch.sin(reg[..., 6:7])], -1)
    diff = (r - t).abs()
    huber = torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5)
    reg_loss = torch.where(pos[..., None], huber, 0.0).sum((-2, -1)) / num_pos

    dir_target = (torch.cos(matched[..., 6]) < 0).long()
    logp = F.log_softmax(direction, dim=-1)
    dir_ce = -torch.gather(logp, -1, dir_target[..., None])[..., 0]
    dir_loss = 0.2 * torch.where(pos, dir_ce, 0.0).sum(-1) / num_pos
    return {"cls": cls_loss, "reg": reg_loss, "dir": dir_loss}


def decode_predictions(cls_logits, reg, direction, anchors) -> Boxes:
    """Flat heads [B, N(, .)] -> Boxes [B, N] over every anchor; the
    direction classifier flips the yaw into its half-circle."""
    boxes7 = decode_deltas(reg, anchors[None])
    flip = direction.argmax(-1) == 1
    yaw = torch.where(flip, boxes7[..., 6] + math.pi, boxes7[..., 6])
    return Boxes(
        pos=boxes7[..., :3], dims=boxes7[..., 3:6], rot=yaw[..., None],
        probs=cls_logits[..., None],
        valid=torch.ones(cls_logits.shape, dtype=torch.bool,
                         device=cls_logits.device),
    ).with_defaults()
