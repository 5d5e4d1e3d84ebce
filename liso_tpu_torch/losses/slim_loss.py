"""SLIM self-supervised loss (port of liso_tpu/losses/slim_loss.py).

The 1-NN of every warped point runs as ONE call per direction over all RAFT
iterations and flow types (`batched_knn_for_iterations`): the banded kernel
K6 on the card, the exact brute force on the CPU (ops/knn_banded.py).
Padded points are handled with masks.

Every batch-wide reduction takes an optional process group (`group`):
with one, the loss is the rank's share of the global batch's loss (its
numerators over the global denominators, parallel/mesh.py), and the
threshold update sums its histogram over the ranks.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from liso_tpu_torch.models.slim import MovAvgState, movavg_update
from liso_tpu_torch.models.slim_decoder import SlimPrediction
from liso_tpu_torch.ops import transforms as tr
from liso_tpu_torch.ops.knn_banded import nn_1_sorted_diff
from liso_tpu_torch.parallel.mesh import batch_mean, batch_total

# x-band of the banded 1-NN: twice the largest displacement of the
# skip-frame curriculum (a 20 m/s object moves 4 m in 0.2 s), as the JAX
# package chose it (`liso_tpu/losses/slim_loss.py:137-143`)
KNN_MARGIN_M = 8.0


class KnnLossCfg(NamedTuple):
    L1_delta: float = 0.0
    drop_outliers_perc: float = 0.0
    fov_mode: str = "mask_close_fov"
    weight_slope: float = 0.0
    slope_sign: float = -1.0
    weight_at_range_0: float = 0.0
    min_weight_clip_at: float = 1.0
    max_weight_clip_at: float = 100.0


class SlimLossCfg(NamedTuple):
    knn_loss_penalty_factor: float = 1.0
    static_flow_penalty_factor: float = 1.0
    fw_bw_static_trafo_penalty_factor: float = 1.0
    knn_on_dynamic_penalty: float = 0.0
    knn_on_static_penalty: float = 0.0
    artificial_cross_entropy_penalty: float = 0.0
    artificial_use_static_aggr_flow: bool = True
    use_static_aggr_flow_for_aggr_flow: bool = False
    knn: KnnLossCfg = KnnLossCfg()
    bev_extent: Tuple[float, float, float, float] = (-50.0, -50.0, 50.0, 50.0)


def huber_delta(err_sqr: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber on a squared error ('large_grad_1'); delta = 0 is the sqrt
    with a gradient-safe zero branch."""
    if delta == 0.0:
        nz = err_sqr != 0.0
        return torch.sqrt(torch.where(nz, err_sqr, 1.0)) * nz.to(err_sqr.dtype)
    return (err_sqr.clamp(max=delta**2) / (2.0 * delta)
            + torch.sqrt(err_sqr.clamp(min=delta**2)) - delta)


def nearest_point_loss(cfg: KnnLossCfg, bev_extent, warped, nearest_dist_sqr,
                       valid):
    """FoV masking + Huber + optional per-row outlier quantile drop.
    warped [R, N, 3], nearest_dist_sqr [R, N], valid [R, N] -> [R, N]
    (0 where invalid)."""
    fov = torch.stack([
        warped[..., 0] - bev_extent[0],
        warped[..., 1] - bev_extent[1],
        bev_extent[2] - warped[..., 0],
        bev_extent[3] - warped[..., 1],
    ], dim=-1)
    min_fov = fov.amin(-1)
    d_sqr = nearest_dist_sqr
    weights = torch.ones_like(min_fov)
    if cfg.fov_mode == "ignore_out_fov":
        weights = (min_fov > 0.0).float()
    elif cfg.fov_mode == "use_nearest":
        d_sqr = torch.minimum(d_sqr, min_fov.square())
    elif cfg.fov_mode == "mask_close_fov":
        weights = (min_fov > 0.0).float() * (d_sqr < min_fov.square()).float()
    elif cfg.fov_mode != "none":
        raise ValueError(cfg.fov_mode)
    loss = huber_delta(d_sqr, cfg.L1_delta)
    if cfg.fov_mode != "none":
        loss = loss * weights
    loss = torch.where(valid, loss, 0.0)
    if cfg.drop_outliers_perc > 0.0:
        keep_q = 1.0 - cfg.drop_outliers_perc / 100.0
        big = torch.where(valid, loss, float("inf"))
        srt = torch.sort(big, dim=-1).values
        n_valid = valid.sum(-1)
        kth = (torch.round(n_valid.float() * keep_q).to(torch.int64) - 1).clamp(
            0, loss.shape[-1] - 1)
        thresh = torch.gather(srt, -1, kth[:, None])
        loss = torch.where(loss <= thresh, loss, 0.0)
    return loss


def flow_knn_multi(cloud_a, valid_a, cloud_b, valid_b, flows: dict):
    """ONE 1-NN call for several flow variants of the same cloud pair: the
    warped clouds concatenate along the point axis. Returns {key: (warped
    [B, N, 3], dist_sqr [B, N])}."""
    keys = sorted(flows)
    n = cloud_a.shape[1]
    warped = {k: cloud_a[..., :3] + flows[k][..., :3] for k in keys}
    q = torch.cat([warped[k] for k in keys], dim=1)
    va = torch.cat([valid_a] * len(keys), dim=1)
    d_all = nn_1_sorted_diff(q, cloud_b[..., :3], va, valid_b, KNN_MARGIN_M)
    d_all = torch.where(va, d_all, 0.0)
    return {k: (warped[k], d_all[:, i * n:(i + 1) * n])
            for i, k in enumerate(keys)}


def flow_knn(cloud_a, valid_a, cloud_b, valid_b, flow_a_to_b):
    """Warp a by flow, 1-NN into b: (warped [B, N, 3], dist_sqr [B, N])."""
    return flow_knn_multi(cloud_a, valid_a, cloud_b, valid_b,
                          {"flow": flow_a_to_b})["flow"]


def knn_flow_types(cfg: SlimLossCfg) -> set:
    """Which flow variants need a 1-NN pass."""
    static_key = "static_aggr" if cfg.use_static_aggr_flow_for_aggr_flow else "static"
    art_static_key = "static_aggr" if cfg.artificial_use_static_aggr_flow else "static"
    types = {"aggregated"}
    if cfg.artificial_cross_entropy_penalty > 0.0:
        types |= {"dynamic", art_static_key}
    if cfg.knn_on_dynamic_penalty != 0.0:
        types.add("dynamic")
    if cfg.knn_on_static_penalty != 0.0:
        types.add(static_key)
    if cfg.use_static_aggr_flow_for_aggr_flow:
        types |= {"dynamic", "static_aggr"}  # the threshold update needs both
    return types


def batched_knn_for_iterations(preds, pca, va, pcb, vb, cfg: SlimLossCfg):
    """ONE 1-NN call for ALL RAFT iterations x flow types of one direction.
    Returns one {type: {loss, dist_sqr}} dict per iteration."""
    types = sorted(knn_flow_types(cfg))
    keys = [f"{it:02d}/{t}" for it in range(len(preds)) for t in types]
    flows = {f"{it:02d}/{t}": getattr(pred, f"{t}_flow")
             for it, pred in enumerate(preds) for t in types}
    res_multi = flow_knn_multi(pca, va, pcb, vb, flows)
    b, n = va.shape
    s = len(keys)
    w_stack = torch.stack([res_multi[k][0] for k in keys], dim=1)
    d_stack = torch.stack([res_multi[k][1] for k in keys], dim=1)
    va_rep = va[:, None].expand(b, s, n).reshape(b * s, n)
    loss_all = nearest_point_loss(
        cfg.knn, cfg.bev_extent, w_stack.reshape(b * s, n, 3),
        d_stack.reshape(b * s, n), va_rep,
    ).reshape(b, s, n)
    out = []
    for it in range(len(preds)):
        res = {}
        for j, t in enumerate(types):
            k = it * len(types) + j
            res[t] = {"loss": loss_all[:, k], "dist_sqr": d_stack[:, k]}
        out.append(res)
    return out


def range_based_weights(cfg: KnnLossCfg, pc, valid, group=None):
    if cfg.weight_slope == 0.0:
        return torch.ones_like(pc[..., 0])
    rng = torch.linalg.norm(pc[..., :3], dim=-1)
    w = (cfg.slope_sign * cfg.weight_slope * rng + cfg.weight_at_range_0).clamp(
        cfg.min_weight_clip_at, cfg.max_weight_clip_at)
    wsum = batch_total(torch.where(valid, w, 0.0).sum(), group)
    return (w * batch_total(valid.sum(), group) / wsum.clamp(min=1e-6)).detach()


def static_points_loss(pc, valid, flow, weights, trafo):
    """Weighted MSE between the (detached) aggregated rigid flow and the
    predicted static flow. [B, N]."""
    pcv = torch.where(valid[..., None], pc[..., :3], 0.0)
    moved = tr.transform_points(trafo.detach(), pcv)
    return (weights[..., None] * (moved - pcv - flow) ** 2).mean(-1)


def trafo_distance(delta_trafo, points, mask):
    """Mean squared displacement of the masked points under delta_trafo's
    top 3 rows. [B]."""
    pts_h = torch.where(mask[..., None], tr.homogenize_pcl(points[..., :3].detach()),
                        0.0)
    delta = torch.einsum("bij,bkj->bki", delta_trafo[:, :3, :], pts_h)
    d_sqr = (delta**2).sum(-1)
    return d_sqr.sum(-1) / mask.sum(-1).clamp(min=1)


def _masked_mean(x, mask, group=None):
    """Mean of x over the set entries of mask (the rank's share of it,
    with a group)."""
    return (torch.where(mask, x, 0.0).sum()
            / batch_total(mask.sum(), group).clamp(min=1))


def slim_loss_single_iteration(pred_fw: SlimPrediction, pred_bw: SlimPrediction,
                               pc1, valid1, pc2, valid2, movavg: MovAvgState,
                               cfg: SlimLossCfg, update_threshold: bool = True,
                               knn_fw=None, knn_bw=None, group=None):
    """One RAFT iteration's loss. Returns (loss scalar, new movavg state,
    metrics dict). knn_fw / knn_bw: precomputed {type: {loss, dist_sqr}}
    from `batched_knn_for_iterations`; when None the searches run here.
    With a process group the loss and metrics are the rank's shares."""
    metrics = {}
    total = pc1.new_zeros(())

    if (cfg.static_flow_penalty_factor != 0.0
            or cfg.fw_bw_static_trafo_penalty_factor != 0.0):
        stat_fw = pred_fw.staticness
        stat_bw = pred_bw.staticness
        if cfg.artificial_cross_entropy_penalty > 0.0:
            stat_fw = stat_fw.detach()
            stat_bw = stat_bw.detach()
        loss_fw = _masked_mean(static_points_loss(
            pc1, valid1, pred_fw.static_flow, stat_fw, pred_fw.static_aggr_trafo),
            valid1, group)
        loss_bw = _masked_mean(static_points_loss(
            pc2, valid2, pred_bw.static_flow, stat_bw, pred_bw.static_aggr_trafo),
            valid2, group)
        static_flow_loss = 0.5 * (loss_fw + loss_bw)
        for_back = torch.einsum("bij,bjk->bik", pred_bw.static_aggr_trafo,
                                pred_fw.static_aggr_trafo) - torch.eye(
            4, device=pc1.device)[None]
        cycle_loss = batch_mean(trafo_distance(
            for_back, torch.cat([pc1[..., :3], pc2[..., :3]], dim=1),
            torch.cat([valid1, valid2], dim=1)), group)
        metrics["static_flow_loss"] = static_flow_loss
        metrics["for_back_static_trafo_loss"] = cycle_loss
        if cfg.static_flow_penalty_factor != 0.0:
            total = total + static_flow_loss * cfg.static_flow_penalty_factor
        if cfg.fw_bw_static_trafo_penalty_factor != 0.0:
            total = total + cycle_loss * cfg.fw_bw_static_trafo_penalty_factor

    static_key = "static_aggr" if cfg.use_static_aggr_flow_for_aggr_flow else "static"
    art_static_key = "static_aggr" if cfg.artificial_use_static_aggr_flow else "static"
    types = knn_flow_types(cfg)

    def knn_all(pred, pca, va, pcb, vb):
        res_multi = flow_knn_multi(
            pca, va, pcb, vb, {t: getattr(pred, f"{t}_flow") for t in sorted(types)})
        return {t: {"loss": nearest_point_loss(cfg.knn, cfg.bev_extent, w, d, va),
                    "dist_sqr": d}
                for t, (w, d) in res_multi.items()}

    if knn_fw is None:
        knn_fw = knn_all(pred_fw, pc1, valid1, pc2, valid2)
    if knn_bw is None:
        knn_bw = knn_all(pred_bw, pc2, valid2, pc1, valid1)

    w_fw = range_based_weights(cfg.knn, pc1, valid1, group)
    w_bw = range_based_weights(cfg.knn, pc2, valid2, group)

    def mm(x, mask):
        return _masked_mean(x, mask, group)

    flow_loss = 0.5 * (mm(w_fw * knn_fw["aggregated"]["loss"], valid1)
                       + mm(w_bw * knn_bw["aggregated"]["loss"], valid2))
    metrics["knn_flow_loss"] = flow_loss
    if cfg.knn_loss_penalty_factor != 0.0:
        total = total + flow_loss * cfg.knn_loss_penalty_factor

    if cfg.knn_on_dynamic_penalty != 0.0:
        dyn_loss = 0.5 * (mm(w_fw * knn_fw["dynamic"]["loss"], valid1)
                          + mm(w_bw * knn_bw["dynamic"]["loss"], valid2))
        metrics["dynamic_flow_loss"] = dyn_loss
        total = total + dyn_loss * cfg.knn_on_dynamic_penalty

    if cfg.knn_on_static_penalty != 0.0:
        stat_loss = 0.5 * (mm(w_fw * knn_fw[static_key]["loss"], valid1)
                           + mm(w_bw * knn_bw[static_key]["loss"], valid2))
        metrics["static_knn_loss"] = stat_loss
        total = total + stat_loss * cfg.knn_on_static_penalty

    if cfg.artificial_cross_entropy_penalty > 0.0:
        def ce(pred, knn_res, valid):
            is_static_label = (knn_res[art_static_key]["dist_sqr"]
                               <= knn_res["dynamic"]["dist_sqr"]).float()
            p = pred.staticness.clamp(1e-7, 1.0 - 1e-7)
            bce = -(is_static_label * torch.log(p)
                    + (1.0 - is_static_label) * torch.log(1.0 - p))
            return mm(bce, valid)

        ce_loss = 0.5 * (ce(pred_fw, knn_fw, valid1) + ce(pred_bw, knn_bw, valid2))
        metrics["ce_loss"] = ce_loss
        total = total + ce_loss * cfg.artificial_cross_entropy_penalty

    if cfg.use_static_aggr_flow_for_aggr_flow and update_threshold:
        movavg = movavg_update(movavg, *threshold_update_inputs(
            pred_fw, pred_bw, knn_fw, knn_bw, valid1, valid2), group=group)

    metrics["total_loss"] = total
    return total, movavg, metrics


def threshold_update_inputs(pred_fw, pred_bw, knn_fw, knn_bw, valid1, valid2):
    """The flat (epes_stat, epes_dyn, dynamicness, valid) the threshold
    update consumes, detached."""
    epes_stat = torch.cat([knn_fw["static_aggr"]["dist_sqr"].sqrt().reshape(-1),
                           knn_bw["static_aggr"]["dist_sqr"].sqrt().reshape(-1)])
    epes_dyn = torch.cat([knn_fw["dynamic"]["dist_sqr"].sqrt().reshape(-1),
                          knn_bw["dynamic"]["dist_sqr"].sqrt().reshape(-1)])
    dyn_scores = torch.cat([pred_fw.dynamicness.reshape(-1),
                            pred_bw.dynamicness.reshape(-1)])
    valid_all = torch.cat([valid1.reshape(-1), valid2.reshape(-1)])
    return epes_stat.detach(), epes_dyn.detach(), dyn_scores.detach(), valid_all
