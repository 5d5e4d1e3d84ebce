"""PointRCNN-style two-stage point detector (port of
liso_tpu/models/pointrcnn.py).

Stage 1 predicts per point: features gathered from a dense BEV backbone at
the point's cell, a point MLP, and two PointNet++-style set abstractions
over the grid-hashed ball query (ops/ball_query.py: the k nearest
in-radius neighbours -> MLP -> masked max), then a foreground logit and a
box proposal per point. The `num_proposals` points of highest foreground
score give the proposals. Stage 2 (`_refine`) pools `roi_points` points
inside each bloated proposal in box coordinates through a shared PointNet
and predicts box deltas and a re-scored confidence.

Parity with the flax module: the proposal top-k and the per-box order of
the points (`argsort(~inside)`) are stable sorts, as jax.lax.top_k and
jnp.argsort order ties; the masked max-pools are `amax`, which splits the
gradient among tied maxima as JAX's max does (the ReLU leaves many ties).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch import nn

from liso_tpu_torch.models.centerpoint import RPN, ConvBNRelu
from liso_tpu_torch.models.pillar_encoder import PillarEncoder
from liso_tpu_torch.ops.ball_query import grid_ball_query
from liso_tpu_torch.ops.bev import BevSetup, point_cell_ids
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.ops.iou import iou_matrix_bev
from liso_tpu_torch.losses.hungarian_loss import hungarian_matching_loss
from liso_tpu_torch.parallel.mesh import batch_total


def _masked_max(h: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """max over `dim` of h where mask, 0 where no element is set."""
    pooled = torch.where(mask[..., None], h, -torch.inf).amax(dim)
    return torch.where(torch.isfinite(pooled), pooled, 0.0)


def _gather_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B, N, C], idx [B, ...] -> [B, ..., C]."""
    b, c = arr.shape[0], arr.shape[-1]
    flat = idx.reshape(b, -1)
    out = torch.gather(arr, 1, flat[..., None].expand(-1, -1, c))
    return out.reshape(*idx.shape, c)


class SetAbstraction(nn.Module):
    """A fixed-K ball query around every point, relative coordinates,
    intensity (and features) through a two-layer MLP, masked max-pool."""

    def __init__(self, bev: BevSetup, radius: float, in_dim: int, k: int = 16,
                 out_dim: int = 64, device=None):
        super().__init__()
        self.bev, self.radius, self.k = bev, radius, k
        self.mlp1 = nn.Linear(in_dim, out_dim, device=device)
        self.mlp2 = nn.Linear(out_dim, out_dim, device=device)

    def forward(self, points, valid, feats=None):
        idx, mask = grid_ball_query(
            points[..., :3], valid, radius=self.radius, k=self.k,
            bev_range_m=tuple(float(r) for r in self.bev.bev_range_m))
        rel = _gather_rows(points[..., :3], idx) - points[..., None, :3]
        parts = [rel, _gather_rows(points[..., 3:4], idx)]
        if feats is not None:
            parts.append(_gather_rows(feats, idx))
        h = torch.relu(self.mlp1(torch.cat(parts, dim=-1)))
        h = torch.relu(self.mlp2(h))
        return _masked_max(h, mask, 2)


class PointRCNNCfg(NamedTuple):
    num_proposals: int = 128
    roi_points: int = 64  # points pooled per proposal
    fg_dist_thresh: float = 1.0
    refine_bloat: float = 1.2


class RoIRefine(nn.Module):
    """Stage 2: canonical RoI point pooling and per-proposal re-scoring.
    Each pooled point carries its xyz in the box's frame, its sensor depth,
    intensity, stage-1 foreground probability and backbone features; a
    shared PointNet encodes the RoI, and separate branches give the
    confidence logit and the box deltas."""

    def __init__(self, cfg: PointRCNNCfg, feat_dim: int = 128, device=None):
        super().__init__()
        kw = dict(device=device)
        self.cfg = cfg
        self.roi_mlp1 = nn.Linear(6 + feat_dim, 128, **kw)
        self.roi_mlp2 = nn.Linear(128, 128, **kw)
        self.cls_fc = nn.Linear(129, 64, **kw)
        self.cls_head = nn.Linear(64, 1, **kw)
        self.reg_fc = nn.Linear(129, 64, **kw)
        self.reg_head = nn.Linear(64, 7, **kw)

    def forward(self, points, valid, point_feats, fg_prob, proposals: Boxes):
        cfg = self.cfg
        inside, p_box = proposals.points_in_box_mask(
            points[..., :3], bloat=cfg.refine_bloat, return_box_coords=True
        )  # [B, N, K], [B, N, K, 3]
        inside = inside & valid[..., None]
        # the first roi_points points inside each box, in cloud order
        order = torch.sort((~inside).to(torch.uint8), dim=1,
                           stable=True).indices[:, : cfg.roi_points]  # [B, R, K]
        sel_in = torch.gather(inside, 1, order)
        sel_box = torch.gather(p_box, 1, order[..., None].expand(-1, -1, -1, 3))
        depth = torch.linalg.norm(points[..., :3], dim=-1, keepdim=True)
        extras = torch.cat([depth, points[..., 3:4], fg_prob[..., None]], -1)
        feats = torch.cat([sel_box, _gather_rows(extras, order),
                           _gather_rows(point_feats, order)], dim=-1)
        feats = torch.where(sel_in[..., None], feats, 0.0)
        roi_feats = feats.transpose(1, 2)  # [B, K, R, C']
        roi_mask = sel_in.transpose(1, 2)  # [B, K, R]

        h = torch.relu(self.roi_mlp1(roi_feats))
        h = torch.relu(self.roi_mlp2(h))
        pooled = _masked_max(h, roi_mask, 2)  # [B, K, 128]
        # the number of pooled points is informative (an empty RoI is junk)
        n_in = roi_mask.sum(dim=2, keepdim=True).to(pooled.dtype)
        pooled = torch.cat([pooled, n_in / float(cfg.roi_points)], dim=-1)
        cls_logit = self.cls_head(torch.relu(self.cls_fc(pooled)))
        out = self.reg_head(torch.relu(self.reg_fc(pooled)))
        d_pos = torch.tanh(out[..., :3]) * 1.0
        d_dims = torch.exp(out[..., 3:6].clamp(-1, 1))
        d_yaw = torch.tanh(out[..., 6:7]) * (math.pi / 4)
        return proposals.replace(
            pos=proposals.pos + d_pos,
            dims=proposals.dims * d_dims,
            rot=proposals.rot + d_yaw,
            probs=cls_logit,
        )


class PointRCNNNet(nn.Module):
    """Returns {fg_logit [B, N], proposals Boxes [B, K], refined Boxes
    [B, K], occupancy}."""

    def __init__(self, bev: BevSetup, cfg: PointRCNNCfg = PointRCNNCfg(),
                 hid_dim: int = 64, point_features: int = 4, device=None):
        super().__init__()
        kw = dict(device=device)
        self.bev, self.cfg = bev, cfg
        self.pfn = PillarEncoder(bev, num_channels=hid_dim,
                                 point_features=point_features, device=device)
        self.backbone = RPN(hid_dim, layer_nums=(3, 5), ds_strides=(1, 2),
                            ds_filters=(hid_dim, 128), us_strides=(1, 2),
                            us_filters=(64, 64), **kw)
        self.reduce = ConvBNRelu(self.backbone.out_channels, 64, 1, **kw)
        self.pt_mlp1 = nn.Linear(4, 32, **kw)
        self.sa1 = SetAbstraction(bev, radius=1.0, in_dim=4, k=16, out_dim=64,
                                  **kw)
        self.sa2 = SetAbstraction(bev, radius=2.5, in_dim=4 + 64, k=16,
                                  out_dim=64, **kw)
        self.pt_mlp2 = nn.Linear(64 + 32 + 64 + 64, 128, **kw)
        self.fg_head = nn.Linear(128, 1, **kw)
        self.prop_head = nn.Linear(128, 8, **kw)
        self._refine = RoIRefine(cfg, 128, **kw)

    def forward(self, points, valid):
        img, occ = self.pfn(points, valid)
        feat = self.reduce(self.backbone(img.permute(0, 3, 1, 2)))
        b, c, fh, fw = feat.shape

        # the BEV features at the points' cells
        cell, in_r, _ = point_cell_ids(
            points[..., :2], BevSetup(self.bev.bev_range_m, (fh, fw)), valid)
        flat = feat.permute(0, 2, 3, 1).reshape(b, fh * fw, c)
        pf = _gather_rows(flat, cell.clamp(0, fh * fw - 1).long())
        pf = torch.where(in_r[..., None], pf, 0.0)
        local = torch.relu(self.pt_mlp1(points[..., :4]))
        sa1 = self.sa1(points, valid)
        sa2 = self.sa2(points, valid, feats=sa1)
        x = torch.relu(self.pt_mlp2(torch.cat([pf, local, sa1, sa2], dim=-1)))

        fg_logit = self.fg_head(x)[..., 0]  # [B, N]
        # per-point proposal: xy offset, z, dims (log), yaw (sin, cos)
        prop = self.prop_head(x)

        score = torch.where(valid, fg_logit, -torch.inf)
        top = torch.sort(score, dim=-1, descending=True,
                         stable=True).indices[:, : self.cfg.num_proposals]
        sel_pts = _gather_rows(points[..., :3], top)
        sel_prop = _gather_rows(prop, top)
        pos = torch.cat([sel_pts[..., :2] + torch.tanh(sel_prop[..., :2]) * 3.0,
                         sel_prop[..., 2:3] + sel_pts[..., 2:3]], dim=-1)
        dims = torch.exp(sel_prop[..., 3:6].clamp(-2, 2)) * torch.tensor(
            [3.9, 1.6, 1.56], device=points.device)
        yaw = torch.atan2(sel_prop[..., 6:7], sel_prop[..., 7:8])
        proposals = Boxes(
            pos=pos, dims=dims, rot=yaw,
            probs=_gather_rows(fg_logit[..., None], top),
            valid=torch.gather(valid, 1, top),
        ).with_defaults()
        refined = self._refine(points, valid, x, torch.sigmoid(fg_logit),
                               proposals)
        return {"fg_logit": fg_logit, "proposals": proposals,
                "refined": refined, "occupancy": occ}


def pointrcnn_loss(out, points, valid, gt: Boxes,
                   group=None) -> Tuple[torch.Tensor, dict]:
    """Stage-1 foreground focal loss, both stages' Hungarian box losses
    (x0.5; stage 2's confidence is trained only by the re-scoring), and the
    re-scoring BCE of stage 2's logit against the refined box's best BEV
    IoU with the GT (positive > 0.55, negative < 0.45, the band between
    ignored). Returns (total, {term: loss}); with a process group, this
    rank's share of the global batch's, every count taken over the group
    (parallel/mesh.py)."""
    fg = gt.points_in_box_mask(points[..., :3]).any(-1) & valid
    p = torch.sigmoid(out["fg_logit"])
    pt = torch.where(fg, p, 1 - p)
    focal = -0.25 * (1 - pt) ** 2 * torch.log(pt.clamp(1e-7, 1))
    losses = {"seg": torch.where(valid, focal, 0.0).sum()
              / batch_total(fg.sum(), group).clamp(min=1)}
    for stage in ("proposals", "refined"):
        for k, v in hungarian_matching_loss(gt, out[stage],
                                            group=group).items():
            if stage == "refined" and k == "probs":
                continue
            losses[f"{stage}_{k}"] = 0.5 * v

    ref: Boxes = out["refined"]
    with torch.no_grad():
        best_iou = torch.stack([
            iou_matrix_bev(ref.pos[i], ref.dims[i], ref.rot[i], gt.pos[i],
                           gt.dims[i], gt.rot[i], ref.valid[i],
                           gt.valid[i]).amax(dim=1)
            for i in range(ref.valid.shape[0])
        ])
    pos_m = best_iou > 0.55
    use = (pos_m | (best_iou < 0.45)) & ref.valid
    z = ref.probs[..., 0].clamp(-30, 30)
    bce = z.clamp(min=0) - z * pos_m.to(z.dtype) + torch.log1p(
        torch.exp(-z.abs()))
    losses["rescore"] = ((bce * use).sum()
                         / batch_total(use.sum(), group).clamp(min=1))
    return sum(losses.values()), losses
