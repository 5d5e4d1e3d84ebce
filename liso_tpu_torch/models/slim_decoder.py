"""SLIM head decoder (port of liso_tpu/models/slim_decoder.py).

Decodes one RAFT iteration's output [B, H, W, 8(+1)] into class
probabilities, static / dynamic / aggregated flows and the
static-aggregation rigid transform, and gathers everything to the points.
The grid -> point gather clamps to the grid edge (`gather_grid_to_points`);
the JAX package's kernel branch there is switched off.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from liso_tpu_torch.ops import kabsch as kab

OFF_LOGIT = -100.0
ON_LOGIT = 100.0


class OutputModification(NamedTuple):
    """Values: 'net' | 'zero' | 'gt' (flows); 'net' | True | False |
    'gt_label_based' | 'gt_flow_based' (logits)."""

    disappearing_logit: object = False
    static_logit: object = "net"
    dynamic_logit: object = "net"
    ground_logit: object = False
    static_flow: str = "net"
    dynamic_flow: str = "net"
    dynamic_flow_grad_scale: float = 1.0


class DecoderCfg(NamedTuple):
    output_modification: OutputModification = OutputModification()
    predict_weight_for_static_aggregation: object = False  # False|'sigmoid'|'softmax'
    use_static_aggr_flow_for_aggr_flow: bool = False
    dynamic_flow_is_non_rigid_flow: bool = False
    use_eps_for_weighted_pc_alignment: bool = False


class SlimPrediction(NamedTuple):
    """Per-point decoded prediction, dense maps and transform."""

    staticness: torch.Tensor  # [B, N]
    dynamicness: torch.Tensor  # [B, N]
    groundness: torch.Tensor  # [B, N]
    is_static: torch.Tensor  # [B, N] bool
    is_dynamic: torch.Tensor
    is_ground: torch.Tensor
    static_flow: torch.Tensor  # [B, N, 3]
    dynamic_flow: torch.Tensor
    aggregated_flow: torch.Tensor
    static_aggr_flow: torch.Tensor
    static_aggr_trafo: torch.Tensor  # [B, 4, 4]
    not_enough_points: torch.Tensor  # [B] bool
    dynamicness_threshold: torch.Tensor  # scalar
    bev_aggregated_flow: torch.Tensor  # [B, H, W, 3]
    bev_static_flow: torch.Tensor  # [B, H, W, 3]
    bev_dynamicness: torch.Tensor  # [B, H, W]
    bev_staticness: torch.Tensor  # [B, H, W]
    bev_groundness: torch.Tensor  # [B, H, W]
    bev_dynamic_flow: torch.Tensor  # [B, H, W, 3]


def scale_gradient(x: torch.Tensor, scaling: float) -> torch.Tensor:
    """Identity forward, gradient scaled by `scaling` backward."""
    if scaling == 1.0:
        return x
    if scaling == 0.0:
        return x.detach()
    return x * scaling - x.detach() * (scaling - 1.0)


def normalized_sigmoid_sum(logits: torch.Tensor, mask: torch.Tensor):
    """Numerically stable sigmoid(x_i) / sum_j sigmoid(x_j) over the masked
    entries of the last axis."""
    neg_part = -torch.relu(-logits)
    weights = torch.sigmoid(logits.abs())
    min_exp = neg_part.amin(-1, keepdim=True)
    exps = torch.where(mask, neg_part, min_exp)
    w = weights * mask
    max_exp = exps.amax(-1, keepdim=True)
    denom = (torch.exp(exps - max_exp) * w).sum(-1, keepdim=True)
    denom = torch.where(denom <= 0, torch.ones_like(denom), denom)
    return torch.exp(torch.where(mask, neg_part, max_exp) - max_exp) * w / denom


def gather_grid_to_points(grid: torch.Tensor, rowcol: torch.Tensor,
                          valid: torch.Tensor, default=0.0):
    """grid [B, H, W, C], int rowcol [B, N, 2] -> [B, N, C]: the cell of
    each point, clamped to the grid; `default` where not valid."""
    b, h, w, c = grid.shape
    r = rowcol[..., 0].long().clamp(0, h - 1)
    col = rowcol[..., 1].long().clamp(0, w - 1)
    flat = (r * w + col).unsqueeze(-1).expand(-1, -1, c)
    vals = torch.gather(grid.reshape(b, h * w, c), 1, flat)
    return torch.where(valid[..., None], vals, default)


def gt_static_flow_from_odom(inv_odom: torch.Tensor,
                             voxel_center_xy: torch.Tensor) -> torch.Tensor:
    """BEV flow of the static world under ego motion: (inv_odom - I)
    applied to the voxel centers. inv_odom [B, 4, 4], voxel_center_xy
    [H, W, 2] -> [B, H, W, 2]."""
    hom = torch.cat([voxel_center_xy, torch.zeros_like(voxel_center_xy[..., :1]),
                     torch.ones_like(voxel_center_xy[..., :1])], dim=-1)
    eye = torch.eye(2, 4, dtype=inv_odom.dtype, device=inv_odom.device)
    return torch.einsum("bij,hwj->bhwi", inv_odom[:, :2, :] - eye, hom)


def _resolve_logit(mode, net_val, others, ones, gt_val=None):
    """One logit channel of the reference's artificial logit switch."""
    if mode == "net":
        return net_val
    if mode is True:
        m = torch.stack([o.max() for o in others]).max().detach()
        return m + ON_LOGIT * ones
    if mode is False:
        m = torch.stack([o.min() for o in others]).min().detach()
        return m + OFF_LOGIT * ones
    if mode in ("gt_label_based", "gt_flow_based"):
        assert gt_val is not None, mode
        return gt_val
    raise ValueError(f"unknown logit mode {mode}")


def decode(network_output: torch.Tensor, dynamicness_threshold: torch.Tensor,
           *, cfg: DecoderCfg, pc: torch.Tensor, rowcol: torch.Tensor,
           point_valid: torch.Tensor, filled_pillar_mask: torch.Tensor,
           inv_odom: torch.Tensor, voxel_center_xy: torch.Tensor,
           gt_flow_bev: Optional[torch.Tensor] = None,
           ohe_gt_labels_bev: Optional[torch.Tensor] = None,
           overwrite_non_filled_pillars_with_default_flow: bool = True,
           overwrite_non_filled_pillars_with_default_logits: bool = True,
           ) -> SlimPrediction:
    om = cfg.output_modification
    fp = filled_pillar_mask[..., None]

    out = network_output
    if cfg.predict_weight_for_static_aggregation is not False:
        weight_logits = out[..., -1]
        out = out[..., :-1]
    else:
        weight_logits = None
    assert out.shape[-1] == 8, out.shape
    disappearing_logit = out[..., 0:1]
    static_logit = out[..., 1:2]
    dynamic_logit = out[..., 2:3]
    ground_logit = out[..., 3:4]
    static_flow = out[..., 4:6]
    dynamic_flow = out[..., 6:8]

    vc = voxel_center_xy.to(torch.float32)
    gt_static_flow = gt_static_flow_from_odom(inv_odom, vc)

    # artificial flow modification
    if om.static_flow == "gt":
        static_flow = gt_static_flow
    elif om.static_flow == "zero":
        static_flow = torch.zeros_like(static_flow)
    else:
        assert om.static_flow == "net", om.static_flow
    if om.dynamic_flow == "gt":
        assert gt_flow_bev is not None
        dynamic_flow = gt_flow_bev
        if cfg.dynamic_flow_is_non_rigid_flow:
            dynamic_flow = dynamic_flow - static_flow
    elif om.dynamic_flow == "zero":
        dynamic_flow = torch.zeros_like(dynamic_flow)
    else:
        assert om.dynamic_flow == "net", om.dynamic_flow
    dynamic_flow = scale_gradient(dynamic_flow, om.dynamic_flow_grad_scale)

    # artificial logit modification
    ones = torch.ones_like(static_logit)
    gt_static_l = gt_dynamic_l = gt_ground_l = None
    if om.static_logit == "gt_label_based":
        if om.ground_logit is False:
            gt_stat = ohe_gt_labels_bev[..., 0:1] | ohe_gt_labels_bev[..., 2:3]
            gt_static_l = ON_LOGIT * (gt_stat.float() - 1.0)
        else:
            gt_static_l = ON_LOGIT * (ohe_gt_labels_bev[..., 0:1].float() - 1.0)
    elif om.static_logit == "gt_flow_based":
        norig = gt_flow_bev - gt_static_flow
        is_stat = (torch.linalg.norm(norig, dim=-1, keepdim=True) <= 0.05).float()
        gt_static_l = ON_LOGIT * (is_stat - 1.0)
    if om.dynamic_logit == "gt_label_based":
        gt_dynamic_l = ON_LOGIT * (ohe_gt_labels_bev[..., 1:2].float() - 1.0)
    elif om.dynamic_logit == "gt_flow_based":
        gt_dynamic_l = ON_LOGIT - gt_static_l
    if om.ground_logit == "gt_label_based":
        gt_ground_l = ON_LOGIT * (ohe_gt_labels_bev[..., 2:3].float() - 1.0)

    if om.disappearing_logit is True:
        disappearing_logit = torch.zeros_like(disappearing_logit)
    elif om.disappearing_logit is False:
        disappearing_logit = OFF_LOGIT * ones
    else:
        assert om.disappearing_logit == "net"

    static_logit = _resolve_logit(om.static_logit, static_logit,
                                  [dynamic_logit, ground_logit], ones, gt_static_l)
    dynamic_logit = _resolve_logit(om.dynamic_logit, dynamic_logit,
                                   [static_logit, ground_logit], ones, gt_dynamic_l)
    ground_logit = _resolve_logit(om.ground_logit, ground_logit,
                                  [static_logit, dynamic_logit], ones, gt_ground_l)

    # default values in non-filled pillars
    if overwrite_non_filled_pillars_with_default_logits:
        disappearing_logit = torch.where(fp, disappearing_logit, OFF_LOGIT)
        static_logit = torch.where(
            fp, static_logit, OFF_LOGIT if om.static_logit is False else 0.0)
        dynamic_logit = torch.where(
            fp, dynamic_logit, 0.0 if om.dynamic_logit is True else OFF_LOGIT)
        ground_logit = torch.where(
            fp, ground_logit, 0.0 if om.ground_logit is True else OFF_LOGIT)
    if overwrite_non_filled_pillars_with_default_flow:
        static_flow = torch.where(fp, static_flow, 0.0)
        dynamic_flow = torch.where(fp, dynamic_flow, 0.0)

    # class probabilities
    class_logits = torch.cat([static_logit, dynamic_logit, ground_logit], -1)
    class_probs = torch.softmax(class_logits, dim=-1)
    staticness = class_probs[..., 0]
    dynamicness = class_probs[..., 1]
    groundness = class_probs[..., 2]
    is_dynamic = dynamicness >= dynamicness_threshold
    is_static = (staticness >= groundness) & (~is_dynamic)
    is_ground = ~(is_static | is_dynamic)

    # static aggregation
    aggr_weight = staticness * filled_pillar_mask.float()
    if cfg.predict_weight_for_static_aggregation is not False:
        mode = cfg.predict_weight_for_static_aggregation
        b, h, w = weight_logits.shape
        flat = weight_logits.reshape(b, h * w)
        flat_mask = filled_pillar_mask.reshape(b, h * w)
        if mode == "softmax":
            masked = torch.where(flat_mask, flat, flat.min() - 1000.0)
            wmap = torch.softmax(masked, dim=-1).reshape(b, h, w)
        else:
            assert mode == "sigmoid", mode
            wmap = normalized_sigmoid_sum(flat, flat_mask).reshape(b, h, w)
        aggr_weight = aggr_weight * wmap

    pointwise_static_flow2 = gather_grid_to_points(static_flow, rowcol,
                                                   point_valid)
    pointwise_staticness_w = gather_grid_to_points(
        aggr_weight[..., None], rowcol, point_valid)[..., 0]
    pts3 = torch.where(point_valid[..., None], pc[..., :3], 0.0)
    flow3 = torch.cat([pointwise_static_flow2,
                       torch.zeros_like(pointwise_static_flow2[..., :1])], -1)
    w = torch.where(point_valid, pointwise_staticness_w, 0.0)
    static_aggr_trafo, not_enough_points = kab.weighted_kabsch(
        pts3, pts3 + flow3, w,
        use_epsilon_on_weights=cfg.use_eps_for_weighted_pc_alignment,
    )
    # rigid BEV flow of the aggregated transform at the voxel centers
    grid_h = torch.cat([vc, torch.zeros_like(vc[..., :1]),
                        torch.ones_like(vc[..., :1])], -1)
    eye = torch.eye(2, 4, dtype=torch.float32, device=vc.device)
    static_aggr_flow = torch.einsum(
        "bij,hwj->bhwi", static_aggr_trafo[:, :2, :] - eye, grid_h)
    masked_static_aggr_flow = torch.where(fp, static_aggr_flow, 0.0)

    def lift(f):
        return torch.cat([f, torch.zeros_like(f[..., :1])], dim=-1)

    static_flow3 = lift(static_flow)
    dynamic_flow3 = lift(dynamic_flow)
    static_aggr_flow3 = lift(static_aggr_flow)
    masked_static_aggr_flow3 = lift(masked_static_aggr_flow)

    if cfg.use_static_aggr_flow_for_aggr_flow:
        static_for_aggr = masked_static_aggr_flow3
    else:
        static_for_aggr = static_flow3
    if cfg.dynamic_flow_is_non_rigid_flow:
        dyn_branch = (static_for_aggr + dynamic_flow3) * (1.0 - groundness[..., None])
    else:
        dyn_branch = dynamic_flow3 * (1.0 - groundness[..., None])
    aggregated_flow = torch.where(is_static[..., None], static_for_aggr, dyn_branch)

    # gather to points
    flt = torch.cat([staticness[..., None], dynamicness[..., None],
                     groundness[..., None], dynamic_flow3, static_flow3,
                     aggregated_flow, static_aggr_flow3], dim=-1)
    pw_flt = gather_grid_to_points(flt, rowcol, point_valid)
    bools = torch.stack([is_static, is_dynamic, is_ground], dim=-1)
    pw_bool = gather_grid_to_points(bools, rowcol, point_valid, default=False)

    return SlimPrediction(
        staticness=pw_flt[..., 0],
        dynamicness=pw_flt[..., 1],
        groundness=pw_flt[..., 2],
        is_static=pw_bool[..., 0],
        is_dynamic=pw_bool[..., 1],
        is_ground=pw_bool[..., 2],
        dynamic_flow=pw_flt[..., 3:6],
        static_flow=pw_flt[..., 6:9],
        aggregated_flow=pw_flt[..., 9:12],
        static_aggr_flow=pw_flt[..., 12:15],
        static_aggr_trafo=static_aggr_trafo,
        not_enough_points=not_enough_points,
        dynamicness_threshold=dynamicness_threshold,
        bev_aggregated_flow=aggregated_flow,
        bev_static_flow=static_flow3,
        bev_dynamicness=dynamicness,
        bev_staticness=staticness,
        bev_groundness=groundness,
        bev_dynamic_flow=dynamic_flow3,
    )
