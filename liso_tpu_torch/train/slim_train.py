"""SLIM training step (port of liso_tpu/train/slim_train.py).

`SlimTrainer` builds the model on the card unless the caller passes
`device="cpu"` (without CUDA it raises) and holds the train state: the
model's parameters and batch-norm statistics, the RMSprop second moment
`nu`, the step, and the moving-average threshold `movavg`. `train_step`
runs one step in place: the forward over all RAFT iterations in both
directions, per-iteration decode and loss, one batched 1-NN per direction,
the threshold update, and the RMSprop update with optax's semantics.
"""
from __future__ import annotations

from typing import Optional

import torch

from liso_tpu_torch.data.sample import FlowSample, PointCloud
from liso_tpu_torch.losses.slim_loss import (
    SlimLossCfg,
    batched_knn_for_iterations,
    slim_loss_single_iteration,
    threshold_update_inputs,
)
from liso_tpu_torch.models.layers import init_weights
from liso_tpu_torch.models.pillar_encoder import pillar_coords
from liso_tpu_torch.models.slim import (
    SlimModel,
    movavg_init,
    movavg_update_batched,
    movavg_value,
)
from liso_tpu_torch.models.slim_decoder import DecoderCfg, decode
from liso_tpu_torch.ops.bev import BevSetup, point_cell_ids, voxel_center_coords
from liso_tpu_torch.serve import resolve_device
from liso_tpu_torch.utils.schedules import polynomial_decay_with_warmup

# optax.rmsprop's defaults: nu starts at 0, eps inside the square root
RMSPROP_DECAY = 0.9
RMSPROP_EPS = 1e-8


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares of every element."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def rmsprop_update_(params, grads, nu, lr: torch.Tensor) -> None:
    """One optax.rmsprop step in place (optax 0.2.6,
    `transform.scale_by_rms` then `scale_by_learning_rate`):
        nu <- (1 - decay) g^2 + decay nu
        p  <- p + (-lr) (g rsqrt(nu + eps))
    torch.optim.RMSprop differs (alpha 0.99, g / (sqrt(v) + eps))."""
    with torch.no_grad():
        for p, g, v in zip(params, grads, nu):
            v.copy_((1.0 - RMSPROP_DECAY) * g.square() + RMSPROP_DECAY * v)
            p.add_((-lr) * (g * torch.rsqrt(v + RMSPROP_EPS)))


class SlimTrainer:
    """Model, train state and the SLIM train / predict steps."""

    def __init__(
        self,
        bev: BevSetup,
        *,
        num_iters: int = 6,
        predict_weight_for_static_aggregation=False,
        use_static_aggr_flow_for_aggr_flow: bool = False,
        loss_cfg: Optional[SlimLossCfg] = None,
        initial_lr: float = 1e-4,
        warmup_steps: int = 2000,
        train_steps: int = 150_000,
        num_train_samples: int = 1,
        compute_dtype=None,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.bev = bev
        self.num_iters = num_iters
        # compute_dtype=torch.bfloat16 runs the convs and the scatter in
        # bf16; parameters, optimizer state and loss stay fp32
        self.model = SlimModel(
            bev, num_iters=num_iters,
            predict_weight_for_static_aggregation=(
                predict_weight_for_static_aggregation),
            compute_dtype=compute_dtype, device=self.device,
        )
        init_weights(self.model, seed, small_std=("heads_conv2",))
        self.dcfg = DecoderCfg(
            predict_weight_for_static_aggregation=(
                predict_weight_for_static_aggregation),
            use_static_aggr_flow_for_aggr_flow=use_static_aggr_flow_for_aggr_flow,
        )
        ext = (-0.5 * bev.bev_range_m[0], -0.5 * bev.bev_range_m[1],
               0.5 * bev.bev_range_m[0], 0.5 * bev.bev_range_m[1])
        self.lcfg = (loss_cfg or SlimLossCfg())._replace(
            bev_extent=ext,
            use_static_aggr_flow_for_aggr_flow=use_static_aggr_flow_for_aggr_flow,
        )
        self.voxel_centers = voxel_center_coords(bev, self.device)
        self.lr_schedule = polynomial_decay_with_warmup(
            initial_lr, warmup_steps, train_steps)
        self.params = dict(self.model.named_parameters())
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.step = 0
        self.movavg = movavg_init(num_train_samples, device=self.device)

    # ------------------------------------------------------------------
    def _sort_batch(self, batch: FlowSample):
        """Sort both clouds by BEV cell id (x-major), stable as
        `jax.lax.sort` is: the loss is invariant, and the banded 1-NN
        kernel needs x-sorted clouds. Returns (batch, (perm0, perm1))."""
        def sort_cloud(pc: PointCloud):
            cell, _, _ = point_cell_ids(pc.pcl[..., :2], self.bev, pc.valid)
            perm = torch.sort(cell, dim=-1, stable=True).indices
            pcl = torch.gather(
                pc.pcl, 1, perm[..., None].expand(-1, -1, pc.pcl.shape[-1]))
            return PointCloud(pcl, torch.gather(pc.valid, 1, perm)), perm

        pc0, perm0 = sort_cloud(batch.pcl_t0)
        pc1, perm1 = sort_cloud(batch.pcl_t1)
        return batch._replace(pcl_t0=pc0, pcl_t1=pc1), (perm0, perm1)

    def _forward_and_loss(self, batch: FlowSample, train: bool,
                          need_loss: bool = True, plain: bool = False):
        """Returns (loss, new movavg, metrics, (last pred_fw, last
        pred_bw)); in train mode the batch-norm running statistics move."""
        batch, _ = self._sort_batch(batch)
        self.model.train(train)
        p0, p1 = batch.pcl_t0, batch.pcl_t1
        out_fw, out_bw, occ0, occ1 = self.model(
            p0.pcl, p0.valid, p1.pcl, p1.valid, plain=plain)
        rc0, _ = pillar_coords(p0.pcl, p0.valid, self.bev)
        rc1, _ = pillar_coords(p1.pcl, p1.valid, self.bev)
        thr = movavg_value(self.movavg)

        # decode every iteration, then ONE batched 1-NN per direction over
        # all iterations x flow types (thr is read once per step)
        preds_fw, preds_bw = [], []
        iters = range(self.num_iters) if need_loss else [self.num_iters - 1]
        for it in iters:
            preds_fw.append(decode(
                out_fw[it], thr, cfg=self.dcfg, pc=p0.pcl, rowcol=rc0,
                point_valid=p0.valid, filled_pillar_mask=occ0 > 0.5,
                inv_odom=batch.odom_t1_t0, voxel_center_xy=self.voxel_centers,
                gt_flow_bev=batch.gt_flow_bev_t0_t1,
            ))
            preds_bw.append(decode(
                out_bw[it], thr, cfg=self.dcfg, pc=p1.pcl, rowcol=rc1,
                point_valid=p1.valid, filled_pillar_mask=occ1 > 0.5,
                inv_odom=batch.odom_t0_t1, voxel_center_xy=self.voxel_centers,
                gt_flow_bev=batch.gt_flow_bev_t1_t0,
            ))
        last_pred = (preds_fw[-1], preds_bw[-1])
        if not need_loss:
            return out_fw.new_zeros(()), self.movavg, {}, last_pred

        knn_fw_all = batched_knn_for_iterations(
            preds_fw, p0.pcl, p0.valid, p1.pcl, p1.valid, self.lcfg, plain)
        knn_bw_all = batched_knn_for_iterations(
            preds_bw, p1.pcl, p1.valid, p0.pcl, p0.valid, self.lcfg, plain)

        total = out_fw.new_zeros((), dtype=torch.float32)
        metrics = {}
        upd_inputs = []
        do_thresh = train and self.lcfg.use_static_aggr_flow_for_aggr_flow
        movavg = self.movavg
        for it in range(self.num_iters):
            it_loss, movavg, it_metrics = slim_loss_single_iteration(
                preds_fw[it], preds_bw[it], p0.pcl, p0.valid, p1.pcl, p1.valid,
                movavg, self.lcfg, update_threshold=False,
                knn_fw=knn_fw_all[it], knn_bw=knn_bw_all[it], plain=plain,
            )
            if do_thresh:
                upd_inputs.append(threshold_update_inputs(
                    preds_fw[it], preds_bw[it], knn_fw_all[it], knn_bw_all[it],
                    p0.valid, p1.valid))
            total = total + it_loss
            if it == self.num_iters - 1:
                metrics = it_metrics
        if upd_inputs:
            # every iteration's histogram in ONE sort + K3 pass; the EMA
            # folds sequentially
            movavg = movavg_update_batched(
                movavg, *(torch.stack(a) for a in zip(*upd_inputs)), plain=plain)
        return total, movavg, metrics, last_pred

    # ------------------------------------------------------------------
    def train_step(self, batch: FlowSample, plain: bool = False) -> dict:
        """One step in place. Returns the JAX train step's metrics (0-dim
        tensors): the last iteration's loss terms, `loss`, `grad_norm` and
        `lr` (the schedule at this step; 0 at step 0)."""
        params = list(self.params.values())
        for p in params:
            p.grad = None
        loss, movavg, metrics, _ = self._forward_and_loss(
            batch, train=True, plain=plain)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        lr = self.lr_schedule(self.step).to(self.device)
        rmsprop_update_(params, grads, list(self.nu.values()), lr)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = global_norm(grads)
        metrics["lr"] = lr
        self.step += 1
        self.movavg = movavg
        return metrics

    @torch.no_grad()
    def predict_step(self, batch: FlowSample, plain: bool = False):
        """Final-iteration predictions (pred_fw, pred_bw) with the per-point
        outputs restored to the caller's point order (the forward runs on
        cell-sorted points). Batch norm uses its running statistics."""
        _, _, _, (pred_fw, pred_bw) = self._forward_and_loss(
            batch, train=False, need_loss=False, plain=plain)
        _, (perm0, perm1) = self._sort_batch(batch)

        def unsort(pred, perm):
            inv = torch.argsort(perm, dim=-1)

            def fix(x):
                if (isinstance(x, torch.Tensor) and x.dim() >= 2
                        and tuple(x.shape[:2]) == tuple(perm.shape)):
                    idx = inv.reshape(inv.shape + (1,) * (x.dim() - 2))
                    return torch.gather(x, 1, idx.expand_as(x))
                return x
            return type(pred)(*(fix(x) for x in pred))

        return unsort(pred_fw, perm0), unsort(pred_bw, perm1)
