"""Detector training step (port of liso_tpu/train/detector_train.py, for
the centerpoint network, baseline or not, and transfusion).

`DetectorTrainer` builds the BoxLearner on the card unless the caller
passes `device="cpu"` (without CUDA it raises) and holds the train state
(`AdamWTrainState`): the model's parameters and batch-norm statistics, the
AdamW moments `mu` and `nu`, the optimizer's `count` and the `step`.
`train_step` runs one step in place: the train-mode forward, the targets
rendered from the target boxes on the device, the loss (centerpoint: the
centermap loss; transfusion: the heatmap focal loss and the Hungarian set
loss of every decoder layer, x0.25), its gradient, and the AdamW update
with optax's semantics under the OneCycle schedule. `predict_step` is the
eval forward with sigmoid, confidence threshold, a pre-NMS cap and rotated
NMS. Both run in fp32, as the JAX trainer does: TF32 is off for cuDNN
convolutions and cuBLAS matmuls while a step runs, and the caller's
settings are put back after it. `state_dict()` / `load_state_dict()` carry
the train state through `utils/checkpoint.py`; `reset_optimizer()` starts
AdamW and the schedule again. Given a process group (`group`,
parallel/mesh.py), a step takes the rank's shard of the batch and gives
every rank the one-process step on the global batch: batch norms and the
loss's counts reduce over the group (transfusion: the heatmap's and each
Hungarian term's; the matching stays per sample, one host stage per rank),
and the gradient is summed once before the update. The PointPillars and
PointRCNN trainers (train/pointpillars_train.py,
train/pointrcnn_train.py) hold the same state through the same class, and
take a group the same way.
"""
from __future__ import annotations

from typing import Optional

import torch

from liso_tpu_torch.data.centermaps import render_centermaps
from liso_tpu_torch.losses.centerpoint_loss import (
    centerpoint_loss,
    focal_heatmap_loss,
)
from liso_tpu_torch.losses.hungarian_loss import hungarian_matching_loss
from liso_tpu_torch.models.box_decode import (
    BoxPredictionCfg,
    apply_activations,
    decode_box_maps,
    flatten_to_boxes,
)
from liso_tpu_torch.models.box_learner import BoxLearner
from liso_tpu_torch.models.layers import init_weights, set_batch_norm_group
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.ops.nms import batched_nms
from liso_tpu_torch.parallel.mesh import all_sum_, replicate, total_metrics
from liso_tpu_torch.serve import resolve_device
from liso_tpu_torch.train.slim_train import (
    adamw_update_,
    fp32_precision,
    global_norm,
)
from liso_tpu_torch.utils import trace
from liso_tpu_torch.utils.schedules import onecycle


class AdamWTrainState:
    """The train state of a detector trainer and its AdamW step: `model`
    (parameters and batch-norm statistics), AdamW's moments `mu` and `nu`
    and its `count` (the OneCycle schedule reads it), and the `step`.
    A subclass builds `model` on `device` and then calls `_init_state`.
    With a process group the state is broadcast from rank 0 and `_update`
    sums the gradient and the loss terms over the group."""

    def _init_state(self, max_lr: float, total_steps: int,
                    weight_decay: float, group=None) -> None:
        self.group = group
        self.weight_decay = weight_decay
        self.lr_schedule = onecycle(max_lr, total_steps)
        self.params = dict(self.model.named_parameters())
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0  # the optimizer's count: its schedule reads it
        self.step = 0
        if group is not None:
            set_batch_norm_group(self.model, group)
            replicate(group, self.state_dict())

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

    # whether the metrics hold the gradient's global norm, as the JAX
    # train step of this class of detector gives it
    grad_norm_metric = False

    def _update(self, losses: dict, total: torch.Tensor):
        """Backward of `total` and one AdamW step in place. Returns the JAX
        train step's metrics, `loss/<term>` for each of `losses` (0-dim
        tensors), `lr` (the schedule at this step) and, where
        `grad_norm_metric`, `grad_norm`. Spans (`utils/trace.py`):
        `det.backward` (the gradients cleared, then the backward; with a
        group, the gradient's sum included) and `det.optimizer` (the
        schedule's rate, AdamW, the norm)."""
        params = list(self.params.values())
        with trace.span("det.backward"):
            for p in params:
                p.grad = None
            total.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            if self.group is not None:
                grads = all_sum_(grads, self.group)
                losses = total_metrics(losses, self.group)
        with trace.span("det.optimizer"):
            lr = float(self.lr_schedule(self.count))
            adamw_update_(params, grads, list(self.mu.values()),
                          list(self.nu.values()), self.count, lr,
                          self.weight_decay)
            metrics = {f"loss/{k}": v.detach() for k, v in losses.items()}
            metrics["lr"] = self.lr_schedule(self.step)
            if self.grad_norm_metric:
                metrics["grad_norm"] = global_norm(grads)
        self.count += 1
        self.step += 1
        return metrics


class DetectorTrainer(AdamWTrainState):
    """Model, train state and the detector's train / predict steps."""

    grad_norm_metric = True

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
        use_baseline_parameters: bool = True,
        num_decoder_layers: int = 1,
        seed: int = 0,
        group=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.bev = bev
        self.network = network
        self.box_cfg = box_cfg or BoxPredictionCfg()
        # fp32, as the JAX trainer builds its BoxLearner (no compute_dtype)
        self.model = BoxLearner(
            bev, box_cfg=self.box_cfg, network=network,
            use_baseline_parameters=use_baseline_parameters,
            num_decoder_layers=num_decoder_layers, device=self.device)
        init_weights(self.model, seed)
        self.nms_iou_threshold = nms_iou_threshold
        self.pre_max_boxes = pre_max_boxes
        self.post_max_boxes = post_max_boxes
        self.confidence_threshold = confidence_threshold
        self._init_state(max_lr, total_steps, weight_decay, group)

    def _loss(self, points, valid, target_boxes: Boxes, ignore_mask):
        """Train-mode forward and loss terms (batch-norm statistics move)."""
        self.model.train()
        flat, decoded, activated, aux = self.model(points, valid)
        if self.network == "transfusion":
            return self._transfusion_loss(flat, aux, target_boxes, ignore_mask)
        gt_maps = render_centermaps(target_boxes, self.bev,
                                    tuple(decoded["probs"].shape[1:3]),
                                    self.box_cfg)
        return centerpoint_loss(
            decoded_pred_maps=decoded, raw_activated_maps=activated,
            gt_maps=gt_maps, center_mask=gt_maps["center_bool_mask"],
            ignore_mask=ignore_mask,
            rotation_method=self.box_cfg.rotation_method,
            group=self.group,
        )

    def _transfusion_loss(self, flat: Boxes, aux: dict, target_boxes: Boxes,
                          ignore_mask):
        """The heatmap focal loss, then each decoder layer's Hungarian set
        loss x0.25, every layer matched on its own; the layers before the
        last carry the suffix `_aux<i>`."""
        heatmap = aux["heatmap"]
        gt_maps = render_centermaps(target_boxes, self.bev,
                                    tuple(heatmap.shape[1:3]), self.box_cfg)
        losses = {"heatmap": focal_heatmap_loss(
            heatmap, gt_maps["probs"], gt_maps["center_bool_mask"],
            ignore_mask, self.group)}
        layer_maps = aux["layer_maps"]
        for li, lm in enumerate(layer_maps):
            layer_flat = flatten_to_boxes(decode_box_maps(
                apply_activations(lm, self.box_cfg), self.box_cfg, self.bev))
            hung = hungarian_matching_loss(target_boxes, layer_flat,
                                           group=self.group)
            suffix = "" if li == len(layer_maps) - 1 else f"_aux{li}"
            for k, v in hung.items():
                losses[f"hungarian_{k}{suffix}"] = 0.25 * v
        losses["total"] = sum(losses.values())
        return losses

    @fp32_precision()
    def train_step(self, points: torch.Tensor, valid: torch.Tensor,
                   target_boxes: Boxes,
                   ignore_mask: Optional[torch.Tensor] = None) -> dict:
        """One step in place. Returns the JAX train step's metrics (0-dim
        tensors): `loss/<term>` for each loss term and the total (centerpoint:
        probs, rot, dims, pos; transfusion: heatmap and hungarian_*), `lr`
        (the schedule at this step) and `grad_norm`. Spans: `det.loss`
        (the forward and the loss terms), then `_update`'s."""
        with trace.span("det.loss"):
            losses = self._loss(points, valid, target_boxes, ignore_mask)
        return self._update(losses, losses["total"])

    @torch.no_grad()
    @fp32_precision()
    def predict_step(self, points: torch.Tensor, valid: torch.Tensor) -> Boxes:
        """Eval forward: decode every anchor cell, sigmoid the probs,
        confidence threshold, keep the `pre_max_boxes` most confident, and
        rotated NMS down to `post_max_boxes` per sample."""
        self.model.eval()
        flat, _, _, _ = self.model(points, valid)
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
