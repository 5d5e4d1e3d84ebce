"""Detector training step (port of liso_tpu/train/detector_train.py for
network="centerpoint").

`DetectorTrainer` builds the BoxLearner on the card unless the caller
passes `device="cpu"` (without CUDA it raises) and holds the train state:
the model's parameters and batch-norm statistics, the AdamW moments `mu`
and `nu`, the optimizer's `count` and the `step`. `train_step` runs one
step in place: the train-mode forward, centermap targets rendered from the
target boxes on the device, the centerpoint loss, its gradient, and the
AdamW update with optax's semantics under the OneCycle schedule.
`predict_step` is the eval forward with sigmoid, confidence threshold, a
pre-NMS cap and rotated NMS. Both run in fp32, as the JAX trainer does:
TF32 is off for cuDNN convolutions and cuBLAS matmuls while a step runs,
and the caller's settings are put back after it. `state_dict()` /
`load_state_dict()` carry the train state through `utils/checkpoint.py`;
`reset_optimizer()` starts AdamW and the schedule again.
"""
from __future__ import annotations

from typing import Optional

import torch

from liso_tpu_torch.data.centermaps import render_centermaps
from liso_tpu_torch.losses.centerpoint_loss import centerpoint_loss
from liso_tpu_torch.models.box_decode import BoxPredictionCfg
from liso_tpu_torch.models.box_learner import BoxLearner
from liso_tpu_torch.models.layers import init_weights
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.ops.nms import batched_nms
from liso_tpu_torch.serve import resolve_device
from liso_tpu_torch.train.slim_train import (
    adamw_update_,
    fp32_precision,
    global_norm,
)
from liso_tpu_torch.utils.schedules import onecycle


class DetectorTrainer:
    """Model, train state and the detector's train / predict steps."""

    def __init__(
        self,
        bev: BevSetup,
        *,
        network: str = "centerpoint",
        box_cfg: Optional[BoxPredictionCfg] = None,
        max_lr: float = 1e-4,
        total_steps: int = 150_000,
        weight_decay: float = 0.01,
        nms_iou_threshold: float = 0.1,
        pre_max_boxes: int = 1000,
        post_max_boxes: int = 100,
        confidence_threshold: float = 0.3,
        seed: int = 0,
        device=None,
    ):
        if network != "centerpoint":
            raise NotImplementedError(f"network {network!r} is not ported yet")
        self.device = resolve_device(device)
        self.bev = bev
        self.box_cfg = box_cfg or BoxPredictionCfg()
        # baseline CenterPoint in fp32, as the JAX trainer builds its
        # BoxLearner (no compute_dtype)
        self.model = BoxLearner(bev, box_cfg=self.box_cfg, device=self.device)
        init_weights(self.model, seed)
        self.nms_iou_threshold = nms_iou_threshold
        self.pre_max_boxes = pre_max_boxes
        self.post_max_boxes = post_max_boxes
        self.confidence_threshold = confidence_threshold
        self.weight_decay = weight_decay
        self.lr_schedule = onecycle(max_lr, total_steps)
        self.params = dict(self.model.named_parameters())
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0  # the optimizer's count: its schedule reads it
        self.step = 0

    def state_dict(self) -> dict:
        """The whole train state (live tensors, not copies): parameters and
        batch-norm statistics, AdamW's moments and count, and the step."""
        return {
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizer": {"mu": dict(self.mu), "nu": dict(self.nu),
                          "count": self.count},
        }

    def load_state_dict(self, state: dict) -> None:
        """Put a state_dict() back, copying every tensor into place on this
        trainer's device."""
        opt = state["optimizer"]
        self.model.load_state_dict(state["model"])
        with torch.no_grad():
            for name in ("mu", "nu"):
                mine = getattr(self, name)
                if set(opt[name]) != set(mine):
                    raise KeyError(f"{name} leaves "
                                   f"{sorted(set(opt[name]) ^ set(mine))} differ")
                for k, v in opt[name].items():
                    mine[k].copy_(v)
        self.count = int(opt["count"])
        self.step = int(state["step"])

    def reset_optimizer(self) -> None:
        """Zero AdamW's moments and count and the step, keeping the weights:
        the OneCycle schedule starts again (a round's reset, a finetune)."""
        with torch.no_grad():
            for m in (*self.mu.values(), *self.nu.values()):
                m.zero_()
        self.count = 0
        self.step = 0

    def _loss(self, points, valid, target_boxes: Boxes, ignore_mask,
              plain: bool):
        """Train-mode forward and loss terms (batch-norm statistics move)."""
        self.model.train()
        _, decoded, activated, _ = self.model(points, valid, plain=plain)
        gt_maps = render_centermaps(target_boxes, self.bev,
                                    tuple(decoded["probs"].shape[1:3]),
                                    self.box_cfg)
        return centerpoint_loss(
            decoded_pred_maps=decoded, raw_activated_maps=activated,
            gt_maps=gt_maps, center_mask=gt_maps["center_bool_mask"],
            ignore_mask=ignore_mask,
            rotation_method=self.box_cfg.rotation_method,
        )

    @fp32_precision()
    def train_step(self, points: torch.Tensor, valid: torch.Tensor,
                   target_boxes: Boxes,
                   ignore_mask: Optional[torch.Tensor] = None,
                   plain: bool = False) -> dict:
        """One step in place. Returns the JAX train step's metrics (0-dim
        tensors): `loss/<term>` for probs, rot, dims, pos and total, `lr`
        (the schedule at this step) and `grad_norm`."""
        params = list(self.params.values())
        for p in params:
            p.grad = None
        losses = self._loss(points, valid, target_boxes, ignore_mask, plain)
        losses["total"].backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        lr = float(self.lr_schedule(self.count))
        adamw_update_(params, grads, list(self.mu.values()),
                      list(self.nu.values()), self.count, lr,
                      self.weight_decay)
        metrics = {f"loss/{k}": v.detach() for k, v in losses.items()}
        metrics["lr"] = self.lr_schedule(self.step)
        metrics["grad_norm"] = global_norm(grads)
        self.count += 1
        self.step += 1
        return metrics

    @torch.no_grad()
    @fp32_precision()
    def predict_step(self, points: torch.Tensor, valid: torch.Tensor,
                     plain: bool = False) -> Boxes:
        """Eval forward: decode every anchor cell, sigmoid the probs,
        confidence threshold, keep the `pre_max_boxes` most confident, and
        rotated NMS down to `post_max_boxes` per sample."""
        self.model.eval()
        flat, _, _, _ = self.model(points, valid, plain=plain)
        probs = torch.sigmoid(flat.probs)
        flat = flat.replace(
            probs=probs,
            valid=flat.valid & (probs[..., 0] >= self.confidence_threshold),
        )
        # pre-NMS cap: jax.lax.top_k takes the largest scores, ties to the
        # lower index; a stable descending sort gives the same order
        k_pre = min(self.pre_max_boxes, flat.k)
        score = torch.where(flat.valid, flat.probs[..., 0], -torch.inf)
        top = torch.sort(score, dim=-1, descending=True, stable=True).indices
        flat = flat.take(top[:, :k_pre])
        return batched_nms(flat, iou_threshold=self.nms_iou_threshold,
                           post_max_boxes=self.post_max_boxes)
