"""SLIM training step (port of liso_tpu/train/slim_train.py).

`SlimTrainer` builds the model on the card unless the caller passes
`device="cpu"` (without CUDA it raises) and holds the train state: the
model's parameters and batch-norm statistics, the optimizer's moments
(RMSprop's `nu`; Adam's `mu`, `nu` and `count`), the step, and the
moving-average threshold `movavg`. `train_step` runs one step in place: the
forward over all RAFT iterations in both directions, per-iteration decode
and loss, one batched 1-NN per direction, the threshold update, and the
optimizer's update with optax's semantics, optionally after clipping the
gradient by its global norm. Both steps run with TF32 off (fp32 convs and
matmuls stay fp32), as DetectorTrainer's do.

Given a process group (`group`, parallel/mesh.py), `train_step` takes the
rank's shard of the batch and gives every rank the one-process step on the
global batch: batch norms and loss denominators reduce over the group, the
threshold histogram is summed over it before the fold, and the gradient is
summed once before its norm, the clipping and the update. The state is
broadcast from rank 0 at construction.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from liso_tpu_torch.data.sample import FlowSample, PointCloud
from liso_tpu_torch.losses.slim_loss import (
    SlimLossCfg,
    batched_knn_for_iterations,
    knn_flow_types,
    slim_loss_single_iteration,
    threshold_update_inputs,
)
from liso_tpu_torch.models.layers import init_weights, set_batch_norm_group
from liso_tpu_torch.models.pillar_encoder import pillar_coords
from liso_tpu_torch.models.slim import (
    MovAvgState,
    SlimModel,
    movavg_init,
    movavg_update_batched,
    movavg_value,
)
from liso_tpu_torch.models.slim_decoder import DecoderCfg, decode
from liso_tpu_torch.ops.bev import BevSetup, point_cell_ids, voxel_center_coords
from liso_tpu_torch.parallel.mesh import all_sum_, replicate, total_metrics
from liso_tpu_torch.serve import resolve_device
from liso_tpu_torch.utils import trace
from liso_tpu_torch.utils.schedules import polynomial_decay_with_warmup

# optax.rmsprop's defaults: nu starts at 0, eps inside the square root
RMSPROP_DECAY = 0.9
RMSPROP_EPS = 1e-8
# optax.adam's and optax.adamw's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares of every element."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_by_global_norm(grads, g_norm: torch.Tensor, max_norm: float):
    """optax.clip_by_global_norm given the norm: every tensor scaled as
    (g / g_norm) * max_norm when g_norm >= max_norm, else kept.
    (torch.nn.utils.clip_grad_norm_ adds 1e-6 to the norm and clamps the
    coefficient: a different result.)"""
    keep = g_norm < max_norm
    return [torch.where(keep, g, (g / g_norm) * max_norm) for g in grads]


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


def adamw_update_(params, grads, mu, nu, count: int, lr,
                  weight_decay: float) -> None:
    """One optax.adamw step in place (optax 0.2.6: `scale_by_adam`,
    `add_decayed_weights` on every leaf, `scale_by_learning_rate`), with
    `count` the optimizer's count before this update and `lr` the
    schedule's rate at that count (a float or a 0-dim tensor):
        mu <- b1 mu + (1 - b1) g,   nu <- b2 nu + (1 - b2) g^2
        u  <- (mu / (1 - b1^(count+1))) / (sqrt(nu / (1 - b2^(count+1))) + eps)
        p  <- p + (-lr) (u + weight_decay p)
    With weight_decay 0 this is optax.adam. The bias corrections are taken
    in fp32, as optax takes them."""
    c = torch.tensor(count + 1, dtype=torch.float32)
    bc1 = float(1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** c)
    bc2 = float(1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** c)
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, mu, nu):
            m.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
            v.mul_(ADAM_B2).add_((1 - ADAM_B2) * g.square())
            u = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
            if weight_decay:
                u = u + weight_decay * p
            p.add_(-lr * u)


def _train_span(name: str, train: bool):
    """The span `name` around a part of a train step; nothing around the
    same code in a prediction."""
    return trace.span(name) if train else contextlib.nullcontext()


@contextlib.contextmanager
def fp32_precision():
    """TF32 off for cuDNN and cuBLAS (PyTorch's default lets cuDNN take
    TF32 for fp32 convolutions) while the block runs; the caller's settings
    are put back after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


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
        optimizer: str = "rmsprop",
        initial_lr: float = 1e-4,
        warmup_steps: int = 2000,
        train_steps: int = 150_000,
        num_train_samples: int = 1,
        grad_clip_norm: float = 0.0,
        compute_dtype=None,
        seed: int = 0,
        detect_anomaly: bool = False,
        group=None,
        device=None,
    ):
        """optimizer: "rmsprop" or "adam" (optax's defaults), after
        clipping by the global norm when grad_clip_norm > 0.
        detect_anomaly: check the loss and the gradient norm of every step
        for non-finite values before the update; on a failure re-run the
        batch under torch.autograd.detect_anomaly() and raise
        FloatingPointError (the port's counterpart of jax_debug_nans).
        group: a torch.distributed process group over which the batch is
        split (module docstring); None trains on the local batch."""
        if optimizer not in ("rmsprop", "adam"):
            raise ValueError(optimizer)
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
        self.optimizer = optimizer
        self.grad_clip_norm = grad_clip_norm
        self.detect_anomaly = detect_anomaly
        self.params = dict(self.model.named_parameters())
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        # Adam's first moment and count (its bias correction); empty and 0
        # under RMSprop
        self.mu = ({k: torch.zeros_like(p) for k, p in self.params.items()}
                   if optimizer == "adam" else {})
        self.count = 0
        self.step = 0
        self.movavg = movavg_init(num_train_samples, device=self.device)
        self.group = group
        if group is not None:
            set_batch_norm_group(self.model, group)
            replicate(group, self.state_dict())

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """The whole train state (live tensors, not copies): parameters and
        batch-norm statistics, the optimizer's moments and count, the step,
        and the threshold state as a dict of tensors."""
        return {
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizer": {"name": self.optimizer, "nu": dict(self.nu),
                          "mu": dict(self.mu), "count": self.count},
            "movavg": self.movavg._asdict(),
        }

    def load_state_dict(self, state: dict) -> None:
        """Put a state_dict() back, copying every tensor into place."""
        opt = state["optimizer"]
        if opt["name"] != self.optimizer:
            raise ValueError(f"state of optimizer {opt['name']!r}, "
                             f"trainer uses {self.optimizer!r}")
        self.model.load_state_dict(state["model"])
        with torch.no_grad():
            for name in ("nu", "mu"):
                mine = getattr(self, name)
                if set(opt[name]) != set(mine):
                    raise KeyError(f"{name} leaves "
                                   f"{sorted(set(opt[name]) ^ set(mine))} differ")
                for k, v in opt[name].items():
                    mine[k].copy_(v)
        self.count = int(opt["count"])
        self.step = int(state["step"])
        self.movavg = MovAvgState(**{
            k: torch.as_tensor(v).to(self.device, torch.float32).clone()
            for k, v in state["movavg"].items()})

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
                          need_loss: bool = True):
        """Returns (loss, new movavg, metrics, (last pred_fw, last
        pred_bw)); in train mode the batch-norm running statistics move."""
        batch, _ = self._sort_batch(batch)
        self.model.train(train)
        p0, p1 = batch.pcl_t0, batch.pcl_t1
        with _train_span("slim.forward", train):
            out_fw, out_bw, occ0, occ1 = self.model(
                p0.pcl, p0.valid, p1.pcl, p1.valid)
        with _train_span("slim.loss", train):
            return self._decode_and_loss(batch, out_fw, out_bw, occ0, occ1,
                                         train, need_loss)

    def _decode_and_loss(self, batch, out_fw, out_bw, occ0, occ1, train,
                         need_loss):
        p0, p1 = batch.pcl_t0, batch.pcl_t1
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
            preds_fw, p0.pcl, p0.valid, p1.pcl, p1.valid, self.lcfg)
        knn_bw_all = batched_knn_for_iterations(
            preds_bw, p1.pcl, p1.valid, p0.pcl, p0.valid, self.lcfg)
        if train:
            # the queries handed to the two 1-NN searches: every iteration
            # and flow type of each direction's padded cloud
            trace.count("slim.knn_queries",
                        len(knn_flow_types(self.lcfg)) * len(preds_fw)
                        * (p0.valid.numel() + p1.valid.numel()))

        total = out_fw.new_zeros((), dtype=torch.float32)
        metrics = {}
        upd_inputs = []
        do_thresh = train and self.lcfg.use_static_aggr_flow_for_aggr_flow
        movavg = self.movavg
        for it in range(self.num_iters):
            it_loss, movavg, it_metrics = slim_loss_single_iteration(
                preds_fw[it], preds_bw[it], p0.pcl, p0.valid, p1.pcl, p1.valid,
                movavg, self.lcfg, update_threshold=False,
                knn_fw=knn_fw_all[it], knn_bw=knn_bw_all[it], group=self.group,
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
                movavg, *(torch.stack(a) for a in zip(*upd_inputs)),
                group=self.group)
        return total, movavg, metrics, last_pred

    # ------------------------------------------------------------------
    def train_step(self, batch: FlowSample) -> dict:
        """One step in place. Returns the JAX train step's metrics (0-dim
        tensors): the last iteration's loss terms, `loss`, `grad_norm` (of
        the gradient before clipping) and `lr` (the schedule at this step;
        0 at step 0). With a group: the global batch's values on every
        rank. Spans (`utils/trace.py`): `slim.loss_and_grads` (with a group,
        the sums over it included), and inside it `slim.forward` (the model
        in both directions), `slim.loss` (decode of every iteration, the two
        batched 1-NN searches, the loss terms and the threshold update) and
        `slim.backward` (`loss.backward()`; autograd launches its kernels
        from its own thread); `slim.optimizer` (the norm, the clip, the rate
        and the update). Counters: `slim.knn_queries`, the queries handed
        to the 1-NN searches; with `detect_anomaly`, `slim.points`, the
        valid points of both clouds, read with the check's values (a
        trainer without the check makes no host read, and counts none)."""
        with fp32_precision():
            params = list(self.params.values())
            with trace.span("slim.loss_and_grads"):
                loss, movavg, metrics, grads = self._loss_and_grads(
                    params, batch)
                if self.group is not None:
                    grads = all_sum_(grads, self.group)
                    metrics = total_metrics({**metrics, "loss": loss},
                                            self.group)
                    loss = metrics.pop("loss")
            with trace.span("slim.optimizer"):
                g_norm = global_norm(grads)
                if self.detect_anomaly:
                    # the step's one host read: the check's two values and
                    # the valid points of both clouds, in one transfer
                    n_points = (batch.pcl_t0.valid.sum()
                                + batch.pcl_t1.valid.sum())
                    lv, gv, npts = torch.stack(
                        [loss.detach(), g_norm, n_points.float()]).tolist()
                    trace.count("slim.points", int(npts))
                    if not (math.isfinite(lv) and math.isfinite(gv)):
                        self._raise_anomaly(params, batch, loss, g_norm)
                if self.grad_clip_norm > 0:
                    grads = clip_by_global_norm(grads, g_norm,
                                                self.grad_clip_norm)
                lr = self.lr_schedule(self.step).to(self.device)
                if self.optimizer == "adam":
                    adamw_update_(params, grads, list(self.mu.values()),
                                  list(self.nu.values()), self.count, lr, 0.0)
                    self.count += 1
                else:
                    rmsprop_update_(params, grads, list(self.nu.values()), lr)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = g_norm
        metrics["lr"] = lr
        self.step += 1
        self.movavg = movavg
        return metrics

    def _loss_and_grads(self, params, batch: FlowSample):
        for p in params:
            p.grad = None
        loss, movavg, metrics, _ = self._forward_and_loss(
            batch, train=True)
        with trace.span("slim.backward"):
            loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        return loss, movavg, metrics, grads

    def _raise_anomaly(self, params, batch, loss, g_norm):
        """The step's loss or gradient is not finite: re-run the batch
        under autograd's anomaly mode, which names the backward op that
        first gave a non-finite value, and raise. No update is applied."""
        msg = (f"SLIM train step {self.step}: loss {float(loss)}, "
               f"grad norm {float(g_norm)}")
        try:
            with torch.autograd.detect_anomaly():
                self._loss_and_grads(params, batch)
        except RuntimeError as e:
            raise FloatingPointError(msg) from e
        raise FloatingPointError(msg + " (anomaly mode named no op)")

    @torch.no_grad()
    @fp32_precision()
    def predict_step(self, batch: FlowSample):
        """Final-iteration predictions (pred_fw, pred_bw) with the per-point
        outputs restored to the caller's point order (the forward runs on
        cell-sorted points). Batch norm uses its running statistics."""
        _, _, _, (pred_fw, pred_bw) = self._forward_and_loss(
            batch, train=False, need_loss=False)
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
