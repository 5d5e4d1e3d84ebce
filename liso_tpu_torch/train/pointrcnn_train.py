"""PointRCNN training (port of liso_tpu/train/pointrcnn_train.py): the
two-stage point pipeline under AdamW + OneCycle, with the interface of
`DetectorTrainer` (`model`, `train_step`, `predict_step`, the train state
of `AdamWTrainState`), so that the rounds loop, mining, validation and the
checkpoints drive it unchanged. Builds on the card unless the caller passes
`device="cpu"`; without CUDA it raises. Steps run in fp32 (TF32 off).
Given a process group (`group`, parallel/mesh.py) a step takes the rank's
shard of the batch: the proposals and the ball queries stay per sample,
the loss's counts (foreground points, matched rows, re-scored boxes) and
the batch norms' statistics are the global batch's, and the gradient is
summed over the ranks."""
from __future__ import annotations

import torch

from liso_tpu_torch.models.layers import init_weights
from liso_tpu_torch.models.pointrcnn import (
    PointRCNNCfg,
    PointRCNNNet,
    pointrcnn_loss,
)
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.ops.nms import batched_nms
from liso_tpu_torch.serve import resolve_device
from liso_tpu_torch.train.detector_train import AdamWTrainState
from liso_tpu_torch.train.slim_train import fp32_precision
from liso_tpu_torch.utils import trace


class PointRCNNTrainer(AdamWTrainState):
    def __init__(
        self,
        bev: BevSetup,
        *,
        cfg: PointRCNNCfg = PointRCNNCfg(),
        max_lr: float = 1e-3,
        total_steps: int = 150_000,
        weight_decay: float = 0.01,
        nms_iou_threshold: float = 0.1,
        post_max_boxes: int = 100,
        confidence_threshold: float = 0.3,
        seed: int = 0,
        group=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.bev = bev
        self.model = PointRCNNNet(bev, cfg=cfg, device=self.device)
        init_weights(self.model, seed)
        self.nms_iou_threshold = nms_iou_threshold
        self.post_max_boxes = post_max_boxes
        self.confidence_threshold = confidence_threshold
        self._init_state(max_lr, total_steps, weight_decay, group)

    @fp32_precision()
    def train_step(self, points: torch.Tensor, valid: torch.Tensor,
                   target: Boxes) -> dict:
        """One step in place. Returns `loss/<term>` for seg, the two
        stages' Hungarian terms, rescore and total, and `lr`."""
        with trace.span("det.loss"):
            self.model.train()
            out = self.model(points, valid)
            total, losses = pointrcnn_loss(out, points, valid, target,
                                           self.group)
        return self._update({**losses, "total": total}, total)

    @torch.no_grad()
    @fp32_precision()
    def predict_step(self, points: torch.Tensor, valid: torch.Tensor) -> Boxes:
        """The refined proposals, sigmoid scores, the confidence threshold,
        and rotated NMS to `post_max_boxes`."""
        self.model.eval()
        boxes: Boxes = self.model(points, valid)["refined"]
        probs = torch.sigmoid(boxes.probs)
        boxes = boxes.replace(
            probs=probs,
            valid=boxes.valid & (probs[..., 0] >= self.confidence_threshold))
        return batched_nms(boxes, iou_threshold=self.nms_iou_threshold,
                           post_max_boxes=self.post_max_boxes)
