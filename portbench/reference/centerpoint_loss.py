"""Plain reference: a frozen copy of liso_tpu_torch/losses/centerpoint_loss.py, without process groups.
It imports nothing of the program; the benchmark compares the program
with it.

The original's docstring:

CenterPoint detection losses: penalty-reduced focal heatmap loss and L1
heads (port of liso_tpu/losses/centerpoint_loss.py). Boolean indexing is
replaced by masked sums (same math, static shapes); every reduction divides
by num_pos = max(1, number of center cells), as the reference does. With a
process group (`group`) the counts are the global batch's over the ranks,
and each term is the rank's share of the global batch's term
(parallel/mesh.py).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.layers import batch_total

FOCAL_GAMMA, FOCAL_ALPHA = 2.0, 0.5


def focal_heatmap_loss(
    pred_logits: torch.Tensor,  # [B, h, w, 1]
    gt_probs: torch.Tensor,  # [B, h, w, 1] gaussian target
    center_mask: torch.Tensor,  # [B, h, w] bool
    ignore_mask: Optional[torch.Tensor] = None,  # [B, h, w] bool
    group=None,
) -> torch.Tensor:
    """Penalty-reduced focal loss with (1 - gt)^4 negative weighting:
    positives at the center cells, negatives elsewhere, ignored cells in
    neither."""
    num_pos = batch_total(center_mask.sum(), group).float().clamp(min=1.0)
    pos_loss = FOCAL_ALPHA * torch.sigmoid(-pred_logits) ** FOCAL_GAMMA * (
        F.logsigmoid(pred_logits))
    neg_loss = ((1 - FOCAL_ALPHA) * torch.sigmoid(pred_logits) ** FOCAL_GAMMA
                * (1.0 - gt_probs) ** 4.0 * F.logsigmoid(-pred_logits))
    cm = center_mask[..., None]
    keep = (torch.ones_like(cm) if ignore_mask is None
            else ~ignore_mask[..., None])
    total = (torch.where(cm & keep, pos_loss, 0.0).sum()
             + torch.where(~cm & keep, neg_loss, 0.0).sum())
    return -total / num_pos


def centerpoint_loss(
    *,
    decoded_pred_maps: Dict[str, torch.Tensor],
    raw_activated_maps: Dict[str, torch.Tensor],
    gt_maps: Dict[str, torch.Tensor],
    center_mask: torch.Tensor,
    ignore_mask: Optional[torch.Tensor] = None,
    rotation_method: str = "vector",
    group=None,
) -> Dict[str, torch.Tensor]:
    """The reference's loss with its quirks kept: the rot loss is a
    weight-normalised L1 on the raw activated rot channels, x10; dims and
    pos are `F.l1_loss(...).sum() / num_pos`, and since l1_loss averages by
    default that is the masked mean over (cells x channels) / num_pos.
    Only the channels the representation predicts are supervised."""
    if rotation_method not in ("direct", "vector"):
        raise ValueError(rotation_method)
    losses = {}
    m = center_mask if ignore_mask is None else center_mask & ~ignore_mask
    num_pos = batch_total(center_mask.sum(), group).float().clamp(min=1.0)

    losses["probs"] = focal_heatmap_loss(
        raw_activated_maps["probs"], gt_maps["probs"], center_mask, ignore_mask,
        group)

    # the reference's per-cell rot weights are all 1 here: max(1, 0.1) * m
    w = m.float()
    w = w / batch_total(w.sum(), group).clamp(min=1.0)
    rot_l1 = (raw_activated_maps["rot"] - gt_maps["rot"]).abs().sum(-1)
    losses["rot"] = 10.0 * (rot_l1 * w).sum()

    for attr in ("dims", "pos"):
        pred = decoded_pred_maps[attr]
        err = (pred - gt_maps[attr][..., : pred.shape[-1]]).abs()
        cnt = (batch_total(m.sum(), group)
               * err.shape[-1]).float().clamp(min=1.0)
        losses[attr] = torch.where(m[..., None], err, 0.0).sum() / cnt / num_pos

    losses["total"] = sum(losses.values())
    return losses
