"""PointPillars training (port of liso_tpu/train/pointpillars_train.py):
the anchor pipeline under AdamW + OneCycle, with the interface of
`DetectorTrainer` (`model`, `train_step`, `predict_step`, the train state
of `AdamWTrainState`), so that the rounds loop, mining, validation and the
checkpoints drive it unchanged. Builds on the card unless the caller passes
`device="cpu"`; without CUDA it raises. Steps run in fp32 (TF32 off).
Given a process group (`group`, parallel/mesh.py) a step takes the rank's
shard of the batch: the anchors, the anchor IoU and the target assignment
stay per sample, the per-sample loss terms are averaged over the global
batch, the batch norms take its statistics, and the gradient is summed
over the ranks."""
from __future__ import annotations

import torch

from liso_tpu_torch.models.layers import init_weights
from liso_tpu_torch.models.pointpillars import (
    AnchorCfg,
    PointPillarsNet,
    decode_predictions,
    make_anchors,
    pointpillars_loss,
)
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.ops.nms import batched_nms
from liso_tpu_torch.parallel.mesh import batch_mean
from liso_tpu_torch.serve import resolve_device
from liso_tpu_torch.train.detector_train import AdamWTrainState
from liso_tpu_torch.train.slim_train import fp32_precision
from liso_tpu_torch.utils import trace


class PointPillarsTrainer(AdamWTrainState):
    def __init__(
        self,
        bev: BevSetup,
        *,
        anchor_cfg: AnchorCfg = AnchorCfg(),
        max_lr: float = 1e-3,
        total_steps: int = 150_000,
        weight_decay: float = 0.01,
        nms_iou_threshold: float = 0.1,
        pre_max_boxes: int = 1000,
        post_max_boxes: int = 100,
        confidence_threshold: float = 0.3,
        seed: int = 0,
        group=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.bev = bev
        self.anchor_cfg = anchor_cfg
        self.model = PointPillarsNet(bev, anchor_cfg=anchor_cfg,
                                     device=self.device)
        init_weights(self.model, seed)
        self.nms_iou_threshold = nms_iou_threshold
        self.pre_max_boxes = pre_max_boxes
        self.post_max_boxes = post_max_boxes
        self.confidence_threshold = confidence_threshold
        self._anchors = {}
        self._init_state(max_lr, total_steps, weight_decay, group)

    def anchors_flat(self, grid_hw) -> torch.Tensor:
        """[h * w * A, 7] anchors of the head grid, on the device."""
        grid_hw = tuple(grid_hw)
        if grid_hw not in self._anchors:
            a = make_anchors(self.bev, grid_hw, self.anchor_cfg)
            self._anchors[grid_hw] = torch.from_numpy(a.reshape(-1, 7)).to(
                self.device)
        return self._anchors[grid_hw]

    @fp32_precision()
    def train_step(self, points: torch.Tensor, valid: torch.Tensor,
                   target: Boxes) -> dict:
        """One step in place. Returns `loss/<term>` for cls, reg, dir (each
        the batch mean of the per-sample loss) and total, and `lr`."""
        with trace.span("det.loss"):
            self.model.train()
            cls, reg, direction, _ = self.model(points, valid)
            b, h, w, a = cls.shape
            per_sample = pointpillars_loss(
                cls.reshape(b, -1), reg.reshape(b, -1, 7),
                direction.reshape(b, -1, 2), self.anchors_flat((h, w)),
                target, self.anchor_cfg)
            losses = {k: batch_mean(v, self.group)
                      for k, v in per_sample.items()}
            total = sum(losses.values())
        return self._update({**losses, "total": total}, total)

    @torch.no_grad()
    @fp32_precision()
    def predict_step(self, points: torch.Tensor, valid: torch.Tensor) -> Boxes:
        """Every anchor's decoded box, sigmoid scores, the `pre_max_boxes`
        most confident (a stable sort: jax.lax.top_k's tie order), the
        confidence threshold, and rotated NMS to `post_max_boxes`."""
        self.model.eval()
        cls, reg, direction, _ = self.model(points, valid)
        b, h, w, a = cls.shape
        boxes = decode_predictions(
            cls.reshape(b, -1), reg.reshape(b, -1, 7),
            direction.reshape(b, -1, 2), self.anchors_flat((h, w)))
        probs = torch.sigmoid(boxes.probs)
        k_pre = min(self.pre_max_boxes, boxes.k)
        top = torch.sort(probs[..., 0], dim=-1, descending=True,
                         stable=True).indices[:, :k_pre]
        boxes = boxes.replace(probs=probs).take(top)
        boxes = boxes.replace(
            valid=boxes.valid & (boxes.probs[..., 0] >= self.confidence_threshold))
        return batched_nms(boxes, iou_threshold=self.nms_iou_threshold,
                           post_max_boxes=self.post_max_boxes)
