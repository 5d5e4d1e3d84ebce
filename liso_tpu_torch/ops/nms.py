"""Rotated NMS on fixed-capacity box sets (port of liso_tpu/ops/nms.py).

Confidence sort (stable, as JAX's argsort), one [K, K] rotated IoU matrix
on the boxes' device, greedy suppression in row order, then the kept boxes
compacted to the front of `post_max_boxes` slots. The greedy loop is K
sequential rows: the thresholded upper triangle of the IoU matrix (K^2
bools, 1 MB at K = 1000) is copied to the host once and the loop runs
there over the rows that are still alive, as the reference's iou3d_nms
does with its suppression bitmasks. The kept set and order are those of the
JAX loop: a row suppresses later rows only while it is itself alive.
"""
from __future__ import annotations

import numpy as np
import torch

from liso_tpu_torch.ops import iou as iou_ops
from liso_tpu_torch.ops.boxes import Boxes


def _greedy_keep(over: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """over [K, K] bool (IoU above the threshold, strictly upper
    triangular), valid [K] -> keep [K]: row i, if valid and not yet
    suppressed, suppresses every later row it overlaps."""
    suppressed = np.zeros(over.shape[0], bool)
    for i in np.flatnonzero(valid):
        if not suppressed[i]:
            suppressed |= over[i]
    return valid & ~suppressed


def batched_nms(boxes: Boxes, iou_threshold: float = 0.1,
                post_max_boxes: int = 100, bev: bool = True) -> Boxes:
    """Greedy rotated NMS over each sample of Boxes [B, K]. Returns Boxes
    [B, post_max_boxes], sorted by confidence; unfilled slots are invalid
    and hold the first sorted box, as the JAX compaction leaves them."""
    bsz, k = boxes.valid.shape
    conf = torch.where(boxes.valid, boxes.probs[..., 0], -torch.inf)
    order = torch.argsort(-conf, dim=-1, stable=True)
    b = boxes.take(order)
    conf = torch.gather(conf, -1, order)
    valid = b.valid & torch.isfinite(conf)
    iou_fn = iou_ops.iou_matrix_bev if bev else iou_ops.iou_matrix_3d
    over = torch.stack([
        torch.triu(iou_fn(b.pos[i], b.dims[i], b.rot[i], b.pos[i], b.dims[i],
                          b.rot[i], valid[i], valid[i]) > iou_threshold, 1)
        for i in range(bsz)
    ])
    over_h, valid_h = over.cpu().numpy(), valid.cpu().numpy()
    out_idx = np.zeros((bsz, post_max_boxes), np.int64)
    out_ok = np.zeros((bsz, post_max_boxes), bool)
    for i in range(bsz):
        kept = np.flatnonzero(_greedy_keep(over_h[i], valid_h[i]))
        kept = kept[:post_max_boxes]
        out_idx[i, : len(kept)] = kept
        out_ok[i, : len(kept)] = True
    dev = boxes.valid.device
    return b.take(torch.from_numpy(out_idx).to(dev),
                  valid=torch.from_numpy(out_ok).to(dev))


def nms_boxes(boxes: Boxes, iou_threshold: float = 0.1,
              post_max_boxes: int = 100, bev: bool = True) -> Boxes:
    """Greedy rotated NMS on one unbatched Boxes [K] -> [post_max_boxes]."""
    batched = Boxes(**{f: None if v is None else v[None]
                       for f, v in vars(boxes).items()})
    out = batched_nms(batched, iou_threshold, post_max_boxes, bev)
    return Boxes(**{f: v[0] for f, v in vars(out).items()})
