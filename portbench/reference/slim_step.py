"""The plain reference of the SLIM train step (`slim_liso`): the model's
training forward in both directions, the decoder, the SLIM loss with an
exact 1-NN and weighted Kabsch, the moving-average dynamicness threshold
and optax's RMSprop, in fp32 with TF32 off; backward by autograd. It
imports nothing of the program.

The model is `reference/raft.py`'s RAFT with its materialised correlation
pyramid and the pillar encoder of `reference/pillar_encoder.py`. One
departure from the published PyTorch LISO, which the configuration lists:
the correlation's operands (f0 and each pooled level of f1) and its scaled
result are rounded to bf16, where the port rounds them
(`liso_tpu_torch/ops/corr_fused.py`, `fused_corr_window_plain`). Autograd
through those casts rounds the cotangents at the same casts: the pyramid's
cotangent, summed over the iterations, to bf16 before the scale, and the
operands' cotangents to bf16 after that sum. The port's backward kernel
(K5) rounds each iteration's tap cotangent times the scale to bf16, keeps
df0 in fp32 and rounds each iteration's df1 to bf16; `corr_vjp="k5"`
gives the reference that backward, so that the two can be told apart
(PERF.md gives the difference's size).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from portbench.reference.bev import BevSetup, voxel_center_coords
from portbench.reference.models import precision
from portbench.reference.pillar_encoder import PillarEncoder, pillar_coords
from portbench.reference.raft import RAFT, lookup_corr, upsample_bilinear

OFF_LOGIT = -100.0
KABSCH_EPS = 1e-7
RMSPROP_DECAY, RMSPROP_EPS = 0.9, 1e-8
# the moving-average threshold (`liso_config.yml`'s SLIM defaults as the
# port's trainer takes them): 100000 bins, start value 0.5, and the update
# weight from the points a KITTI training set moves
MOVAVG_RES, MOVAVG_START, MOVAVG_MOVING = 100_000, 0.5, 621_013_971
KNN_CHUNK = 4096  # queries per block of the exact 1-NN


class SlimCfg(NamedTuple):
    """What the reference needs of the configuration (its file's `slim`
    and `train` blocks)."""
    bev: BevSetup
    num_iters: int = 6
    corr_levels: int = 4
    corr_radius: int = 3
    pillar_channels: int = 64
    hidden_dim: int = 96
    context_dim: int = 64
    corr_feature_dim: int = 128
    downsample: int = 8
    learning_rate: float = 1e-4
    warmup_steps: int = 2000
    train_steps: int = 150_000
    lr_end_factor: float = 0.05


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class _RoundPassGrad(torch.autograd.Function):
    """x rounded to bf16 (held in fp32), the cotangent passed on in fp32,
    as the port holds its correlation operands."""

    @staticmethod
    def forward(ctx, x):
        return round_bf16(x)

    @staticmethod
    def backward(ctx, g):
        return g


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
class _K5Window(torch.autograd.Function):
    """One lookup's raw taps of one level with the port's K5 backward:
    the taps' cotangent times the scale rounded to bf16 per element, df0
    in fp32, df1 rounded to bf16 (each lookup on its own)."""

    @staticmethod
    def forward(ctx, corr, f0b, f1b, flat, ok, scale):
        ctx.save_for_backward(f0b, f1b, flat, ok)
        ctx.scale = scale
        ctx.shape = corr.shape
        return torch.where(ok, torch.gather(corr, 2, flat), 0.0)

    @staticmethod
    def backward(ctx, g):
        f0b, f1b, flat, ok = ctx.saved_tensors
        d = torch.where(ok, round_bf16(g * ctx.scale), 0.0)
        dcorr = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        dcorr.scatter_add_(2, flat, d)
        df0 = dcorr @ f1b.transpose(1, 2)
        df1 = round_bf16(f0b.transpose(1, 2) @ dcorr)
        return None, df0, df1, None, None, None


def lookup_corr_k5(levels, coords, radius: int):
    """`raft.lookup_corr` over (corr, f0b, f1b, scale) levels, with the
    raw taps' backward of the port's kernel (`_K5Window`)."""
    b, h, w, _ = coords.shape
    win = 2 * radius + 1
    d = torch.arange(-radius, radius + 2, device=coords.device)
    out = []
    for lvl, (corr, f0b, f1b, scale, hk, wk) in enumerate(levels):
        centers = coords.reshape(b, h * w, 2) / (2.0**lvl)
        r0 = torch.floor(centers[..., 0])
        c0 = torch.floor(centers[..., 1])
        fr = (centers[..., 0] - r0)[..., None, None]
        fc = (centers[..., 1] - c0)[..., None, None]
        rows = r0.long()[..., None] + d
        cols = c0.long()[..., None] + d
        ok = (((rows >= 0) & (rows < hk))[..., :, None]
              & ((cols >= 0) & (cols < wk))[..., None, :]).reshape(b, h * w, -1)
        flat = (rows.clamp(0, hk - 1)[..., :, None] * wk
                + cols.clamp(0, wk - 1)[..., None, :]).reshape(b, h * w, -1)
        wnd = _K5Window.apply(corr, f0b, f1b, flat, ok, scale).reshape(
            b, h * w, win + 1, win + 1)
        s = (wnd[..., :win, :win] * (1 - fr) * (1 - fc)
             + wnd[..., :win, 1:] * (1 - fr) * fc
             + wnd[..., 1:, :win] * fr * (1 - fc)
             + wnd[..., 1:, 1:] * fr * fc)
        out.append(s.transpose(-2, -1).reshape(b, h, w, win * win))
    return torch.cat(out, dim=-1)


def corr_pyramid_bf16(fmap0, fmap1, num_levels: int, vjp: str = "autograd"):
    """`raft.build_corr_pyramid` with the port's bf16 roundings: f0 and
    each 2x2-average-pooled level of fmap1 rounded to bf16, their fp32
    product scaled by 1/sqrt(C) and rounded to bf16. Returns a lookup
    `coords [B, H, W, 2] -> [B, H, W, L*(2r+1)^2]` (`radius` as its second
    argument)."""
    b, h, w, c = fmap0.shape
    scale = 1.0 / c**0.5
    rnd = round_bf16 if vjp == "autograd" else _RoundPassGrad.apply
    f0b = rnd(fmap0.reshape(b, h * w, c))
    f1l = fmap1.permute(0, 3, 1, 2)
    levels = []
    for _ in range(num_levels):
        hk, wk = f1l.shape[-2:]
        f1b = rnd(f1l.reshape(b, c, hk * wk))
        if vjp == "autograd":
            corr = round_bf16(torch.matmul(f0b, f1b) * scale)
            levels.append(corr.reshape(b, h * w, hk, wk))
        else:
            with torch.no_grad():
                corr = round_bf16(torch.matmul(f0b, f1b) * scale)
            levels.append((corr, f0b, f1b, scale, hk, wk))
        if min(hk, wk) < 4:
            break
        f1l = torch.nn.functional.avg_pool2d(f1l, 2, 2)
    if vjp == "autograd":
        return lambda coords, radius: lookup_corr(levels, coords, radius)
    return lambda coords, radius: lookup_corr_k5(levels, coords, radius)


class RaftBf16Corr(RAFT):
    """The reference RAFT with the bf16-rounded correlation pyramid."""

    def __init__(self, *args, corr_vjp: str = "autograd", **kw):
        super().__init__(*args, **kw)
        self.corr_vjp = corr_vjp

    def flow_from_features(self, fmap0, cn, fmap1, upsample_all: bool = True,
                           plain: bool = False):
        b, h, w, _ = fmap0.shape
        lookup = corr_pyramid_bf16(fmap0, fmap1, self.corr_levels,
                                   self.corr_vjp)
        cn = cn.permute(0, 3, 1, 2)
        net = torch.tanh(cn[:, : self.hidden_dim])
        inp = torch.relu(cn[:, self.hidden_dim:])
        dev = fmap0.device
        coords0 = torch.stack(torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev),
            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij"),
            dim=0)[None].expand(b, 2, h, w)
        flow = torch.zeros(b, 2, h, w, device=dev)
        logits = torch.zeros(b, 4, h, w, device=dev)
        wlog = torch.zeros(b, 1, h, w, device=dev)
        m_per_px = self.resolution_m * self.downsample
        outputs = []
        for _ in range(self.num_iters):
            flow, logits, wlog = flow.detach(), logits.detach(), wlog.detach()
            corr = lookup((coords0 + flow).permute(0, 2, 3, 1),
                          self.corr_radius).permute(0, 3, 1, 2)
            net, dflow, dlogits, dw = self.update_block(net, inp, corr, flow,
                                                        logits, wlog)
            flow, logits, wlog = flow + dflow, logits + dlogits, wlog + dw
            up_flow = upsample_bilinear(flow, self.downsample) * m_per_px
            outputs.append(torch.cat(
                [upsample_bilinear(logits, self.downsample), up_flow, up_flow,
                 upsample_bilinear(wlog, self.downsample)],
                dim=1).permute(0, 2, 3, 1))
        return torch.stack(outputs, dim=0)


class RefSlimTrain(nn.Module):
    """SLIM's pillar encoder and RAFT with the static-aggregation weight
    (`slim.SlimModel`'s layout and parameter names), trained in both
    directions. `conv_dtype` runs RAFT's convolutions in that type (a
    control)."""

    def __init__(self, cfg: SlimCfg, conv_dtype=None, corr_vjp="autograd",
                 device=None):
        super().__init__()
        self.pillar_encoder = PillarEncoder(
            cfg.bev, num_channels=cfg.pillar_channels, device=device)
        self.raft = RaftBf16Corr(
            cfg.bev.grid_size, in_channels=cfg.pillar_channels,
            num_iters=cfg.num_iters, corr_levels=cfg.corr_levels,
            corr_radius=cfg.corr_radius, hidden_dim=cfg.hidden_dim,
            context_dim=cfg.context_dim,
            corr_feature_dim=cfg.corr_feature_dim, downsample=cfg.downsample,
            resolution_m=cfg.bev.res_m[0],
            predict_weight_for_static_aggregation=True, dtype=conv_dtype,
            corr_vjp=corr_vjp, device=device)

    def forward(self, p0, v0, p1, v1):
        img0, occ0 = self.pillar_encoder(p0, v0)
        img1, occ1 = self.pillar_encoder(p1, v1)
        return (self.raft(img0, img1), self.raft(img1, img0),
                occ0[..., 0], occ1[..., 0])


# ---------------------------------------------------------------------------
# the decoder (`slim_liso`: the network's logits and flows, the sigmoid
# weight of the static aggregation, static-aggregated flow for the
# aggregated flow)
# ---------------------------------------------------------------------------
def weighted_kabsch(x, y, w):
    """T = [R|t] minimising sum_i w_i ||R x_i + t - y_i||^2 over [B, N, 3]
    points, R the closest rotation to the weighted cross-covariance by
    `torch.linalg.svd`. With fewer than 3 weighted points every weight
    gets 1e-7 (the published fallback)."""
    w = w.clamp(min=0.0)
    enough = (w > 0).sum(-1) >= 3
    w = torch.where(enough[..., None], w, w + KABSCH_EPS)
    cum = w.sum(-1)[..., None]
    mx = (x * w[..., None]).sum(-2) / cum
    my = (y * w[..., None]).sum(-2) / cum
    xc, yc = x - mx[..., None, :], y - my[..., None, :]
    sxy = torch.einsum("bni,bnj->bij", yc * w[..., None], xc) / cum[..., None]
    u, _, vh = torch.linalg.svd(sxy)
    r = u @ vh
    t = my - torch.einsum("bij,bj->bi", r, mx)
    top = torch.cat([r, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def _gather(grid, rowcol, valid, default=0.0):
    """[B, H, W, C] at each point's cell -> [B, N, C]; `default` where
    not valid."""
    b, h, w, c = grid.shape
    r = rowcol[..., 0].long().clamp(0, h - 1)
    col = rowcol[..., 1].long().clamp(0, w - 1)
    flat = (r * w + col).unsqueeze(-1).expand(-1, -1, c)
    vals = torch.gather(grid.reshape(b, h * w, c), 1, flat)
    return torch.where(valid[..., None], vals, default)


def _sigmoid_weights(logits, mask):
    """sigmoid(x_i) / sum_j sigmoid(x_j) over the masked entries of the
    last axis, computed stably."""
    neg = -torch.relu(-logits)
    sig = torch.sigmoid(logits.abs())
    exps = torch.where(mask, neg, neg.amin(-1, keepdim=True))
    w = sig * mask
    top = exps.amax(-1, keepdim=True)
    denom = (torch.exp(exps - top) * w).sum(-1, keepdim=True)
    denom = torch.where(denom <= 0, torch.ones_like(denom), denom)
    return torch.exp(torch.where(mask, neg, top) - top) * w / denom


def decode(out, thr, pc, rowcol, valid, filled, voxel_xy):
    """One iteration's output [B, H, W, 9] -> per-point staticness,
    dynamicness and flows ([B, N, 3]: static, dynamic, aggregated,
    static-aggregated) and the static-aggregation transform."""
    fp = filled[..., None]
    wlog = out[..., 8]
    static_logit, dynamic_logit = out[..., 1:2], out[..., 2:3]
    static_flow, dynamic_flow = out[..., 4:6], out[..., 6:8]
    ground_logit = (torch.stack([static_logit.min(), dynamic_logit.min()])
                    .min().detach() + OFF_LOGIT)
    ground_logit = ground_logit * torch.ones_like(static_logit)
    static_logit = torch.where(fp, static_logit, 0.0)
    dynamic_logit = torch.where(fp, dynamic_logit, OFF_LOGIT)
    ground_logit = torch.where(fp, ground_logit, OFF_LOGIT)
    static_flow = torch.where(fp, static_flow, 0.0)
    dynamic_flow = torch.where(fp, dynamic_flow, 0.0)
    probs = torch.softmax(torch.cat([static_logit, dynamic_logit,
                                     ground_logit], -1), dim=-1)
    staticness, dynamicness, groundness = probs.unbind(-1)
    is_dynamic = dynamicness >= thr
    is_static = (staticness >= groundness) & ~is_dynamic

    b, h, w = wlog.shape
    wmap = _sigmoid_weights(wlog.reshape(b, h * w),
                            filled.reshape(b, h * w)).reshape(b, h, w)
    aggr_w = staticness * filled.float() * wmap
    pw_static2 = _gather(static_flow, rowcol, valid)
    pw_w = torch.where(valid, _gather(aggr_w[..., None], rowcol, valid)[..., 0],
                       0.0)
    pts3 = torch.where(valid[..., None], pc[..., :3], 0.0)
    flow3 = torch.cat([pw_static2, torch.zeros_like(pw_static2[..., :1])], -1)
    trafo = weighted_kabsch(pts3, pts3 + flow3, pw_w)
    grid_h = torch.cat([voxel_xy, torch.zeros_like(voxel_xy[..., :1]),
                        torch.ones_like(voxel_xy[..., :1])], -1)
    eye = torch.eye(2, 4, device=voxel_xy.device)
    aggr_flow2 = torch.einsum("bij,hwj->bhwi", trafo[:, :2, :] - eye, grid_h)

    def lift(f):
        return torch.cat([f, torch.zeros_like(f[..., :1])], dim=-1)

    static3, dynamic3, aggr3 = lift(static_flow), lift(dynamic_flow), lift(aggr_flow2)
    aggregated = torch.where(is_static[..., None],
                             torch.where(fp, aggr3, 0.0),
                             dynamic3 * (1.0 - groundness[..., None]))
    flt = torch.cat([staticness[..., None], dynamicness[..., None], dynamic3,
                     static3, aggregated, aggr3], dim=-1)
    pw = _gather(flt, rowcol, valid)
    return {"staticness": pw[..., 0], "dynamicness": pw[..., 1],
            "dynamic": pw[..., 2:5], "static": pw[..., 5:8],
            "aggregated": pw[..., 8:11], "static_aggr": pw[..., 11:14],
            "trafo": trafo}


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------
def nearest_index(q, r):
    """The index of each query's nearest ref, q [M, 3], r [N, 3]: the
    squared distances as |q|^2 + |r|^2 - 2 q.r in float64 over blocks of
    queries (rounding 1e-12 m^2 at 60 m, where fp32 would pick a wrong
    neighbour among near ties)."""
    q, r = q.detach().double(), r.detach().double()
    r2 = (r * r).sum(-1)
    out = []
    for s in range(0, q.shape[0], KNN_CHUNK):
        qc = q[s:s + KNN_CHUNK]
        d = (qc * qc).sum(-1)[:, None] + r2[None, :] - 2.0 * (qc @ r.T)
        out.append(d.argmin(-1))
    return torch.cat(out)


def nn_dist_sqr(q, refs, q_valid, r_valid):
    """Exact 1-NN of each query among the valid refs (`nearest_index`);
    the squared distance to the chosen ref recomputed in fp32 as the sum of
    squared differences, with the gradient in q (the ref is data).
    q [B, M, 3], refs [B, N, 3] -> [B, M], 0 for invalid queries."""
    out = []
    for i in range(q.shape[0]):
        r = refs[i][r_valid[i]]
        d = ((q[i] - r[nearest_index(q[i], r)]) ** 2).sum(-1)
        out.append(torch.where(q_valid[i], d, 0.0))
    return torch.stack(out)


KNN_TYPES = ("aggregated", "dynamic", "static_aggr")


def knn_distances(preds, pca, va, pcb, vb):
    """The squared 1-NN distance of every iteration's and flow type's
    warped cloud a in cloud b: [(type -> (warped [B, N, 3], d2 [B, N]))]
    over the iterations."""
    n_types = len(KNN_TYPES)
    warped = [pca[..., :3] + p[t] for p in preds for t in KNN_TYPES]
    d2 = nn_dist_sqr(torch.cat(warped, 1), pcb[..., :3],
                     va.repeat(1, len(warped)), vb)
    n = va.shape[1]
    return [{t: (warped[i * n_types + j],
                 d2[:, (i * n_types + j) * n:(i * n_types + j + 1) * n])
             for j, t in enumerate(KNN_TYPES)} for i in range(len(preds))]


def knn_loss(warped, d2, valid, extent):
    """The distance to the nearest point, in m (`L1_delta` 0), with
    `fov_mode: mask_close_fov`: counted only where the warped point lies
    inside the BEV and nearer its neighbour than the BEV's edge."""
    fov = torch.stack([warped[..., 0] - extent[0], warped[..., 1] - extent[1],
                       extent[2] - warped[..., 0], extent[3] - warped[..., 1]],
                      -1).amin(-1)
    weights = (fov > 0.0).float() * (d2 < fov.square()).float()
    nz = d2 != 0.0
    dist = torch.sqrt(torch.where(nz, d2, 1.0)) * nz.float()
    return torch.where(valid, dist * weights, 0.0)


def masked_mean(x, mask):
    return torch.where(mask, x, 0.0).sum() / mask.sum().clamp(min=1)


def transform_points(t, pts):
    return torch.einsum("bij,bnj->bni", t[:, :3, :3], pts) + t[:, None, :3, 3]


def static_points_loss(pc, valid, flow, weights, trafo):
    pcv = torch.where(valid[..., None], pc[..., :3], 0.0)
    moved = transform_points(trafo.detach(), pcv)
    return (weights[..., None] * (moved - pcv - flow) ** 2).mean(-1)


def trafo_distance(delta, points, mask):
    pts = torch.cat([points[..., :3].detach(),
                     torch.ones_like(points[..., :1])], -1)
    pts = torch.where(mask[..., None], pts, 0.0)
    d = torch.einsum("bij,bkj->bki", delta[:, :3, :], pts)
    return (d ** 2).sum(-1).sum(-1) / mask.sum(-1).clamp(min=1)


def iteration_loss(pf, pb, knn_f, knn_b, p0, v0, p1, v1, extent):
    """One iteration's loss terms: the static flow against its aggregated
    transform, the forward-backward transform cycle, the 1-NN loss of the
    aggregated flow, and their sum."""
    stat = 0.5 * (
        masked_mean(static_points_loss(p0, v0, pf["static"], pf["staticness"],
                                       pf["trafo"]), v0)
        + masked_mean(static_points_loss(p1, v1, pb["static"],
                                         pb["staticness"], pb["trafo"]), v1))
    eye = torch.eye(4, device=p0.device)[None]
    cycle = trafo_distance(pb["trafo"] @ pf["trafo"] - eye,
                           torch.cat([p0[..., :3], p1[..., :3]], 1),
                           torch.cat([v0, v1], 1)).mean()
    knn = 0.5 * (masked_mean(knn_loss(*knn_f["aggregated"], v0, extent), v0)
                 + masked_mean(knn_loss(*knn_b["aggregated"], v1, extent), v1))
    return {"static_flow_loss": stat, "for_back_static_trafo_loss": cycle,
            "knn_flow_loss": knn, "total_loss": stat + cycle + knn}


# ---------------------------------------------------------------------------
# the moving-average threshold
# ---------------------------------------------------------------------------
class MovAvg(NamedTuple):
    importance: torch.Tensor
    bias: torch.Tensor
    update_weight: torch.Tensor


def movavg_init(num_train_samples: int, device) -> MovAvg:
    per_sample = MOVAVG_MOVING / max(num_train_samples, 1)
    uw = 1.0 / min(2.0 * MOVAVG_MOVING, 5_000.0 * per_sample)
    return MovAvg(torch.zeros(MOVAVG_RES, device=device),
                  torch.tensor(0.0, device=device),
                  torch.tensor(uw, dtype=torch.float32, device=device))


def movavg_value(state: MovAvg) -> torch.Tensor:
    """The mean bin index at which the cumulative improvement is least,
    over the resolution; the start value before the first update."""
    res = state.importance.shape[0]
    improv = torch.cat([state.importance.new_zeros(1),
                        torch.cumsum(state.importance, 0)])
    best = (improv == improv.min()).float()
    idx = torch.arange(res + 1, dtype=torch.float32, device=improv.device)
    mean_idx = (idx * best).sum() / best.sum()
    return torch.where(state.bias > 0.0, mean_idx / res,
                       torch.tensor(MOVAVG_START, device=improv.device))


def improvement_curve(importance: torch.Tensor) -> torch.Tensor:
    """The cumulative improvement over the bins, from 0 (float64): the
    threshold is the mean bin at its least value."""
    return torch.cat([importance.new_zeros(1, dtype=torch.float64),
                      torch.cumsum(importance.double(), 0)])


def movavg_update(state: MovAvg, epe_stat, epe_dyn, dynamicness,
                  valid) -> MovAvg:
    """One update from flat inputs: the improvements (static error less
    dynamic error) of the valid points summed into dynamicness bins, and
    folded into the importance with the weight of `count` updates."""
    res = state.importance.shape[0]
    bins = (dynamicness * res).to(torch.int32).clamp(0, res - 1).long()
    hist = torch.zeros(res, device=epe_stat.device).index_add_(
        0, bins[valid], (epe_stat - epe_dyn)[valid])
    count = valid.sum().float()
    # 1 - (1 - uw)^count by expm1 and log1p: exact in fp32 for uw ~ 1e-9
    new_w = -torch.expm1(count * torch.log1p(-state.update_weight))
    keep = 1.0 - new_w
    return state._replace(importance=state.importance * keep + new_w * hist,
                          bias=state.bias * keep + new_w)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def lr_at(cfg: SlimCfg, step: int) -> float:
    """Linear warm-up to the rate, then a linear decay to 5% of it, in
    fp32."""
    s = torch.tensor(float(step), dtype=torch.float32)
    lr = cfg.learning_rate
    if step < cfg.warmup_steps:
        return float(s / max(1, cfg.warmup_steps) * lr)
    end = lr * cfg.lr_end_factor
    left = (1.0 - (s - cfg.warmup_steps)
            / max(1, cfg.train_steps - cfg.warmup_steps)).clamp(0.0, 1.0)
    return float((lr - end) * left + end)


def rmsprop_(params, grads, nu, lr: float):
    """optax.rmsprop: nu <- 0.1 g^2 + 0.9 nu; p <- p - lr g / sqrt(nu +
    eps)."""
    with torch.no_grad():
        for p, g, v in zip(params, grads, nu):
            v.copy_((1.0 - RMSPROP_DECAY) * g.square() + RMSPROP_DECAY * v)
            p.add_((-lr) * (g * torch.rsqrt(v + RMSPROP_EPS)))


def step_loss(model, cfg: SlimCfg, batch, thr, voxel_xy):
    """The forward, every iteration's decode and loss, and the threshold
    update's inputs of one batch (p0, v0, p1, v1 tensors). Returns (loss,
    the last iteration's terms, the update's inputs per iteration, the last
    iteration's flow frame 0 -> 1 and 1 -> 0 [B, H, W, 2] in m)."""
    p0, v0, p1, v1 = batch
    out_fw, out_bw, occ0, occ1 = model(p0, v0, p1, v1)
    rc0, _ = pillar_coords(p0, v0, cfg.bev)
    rc1, _ = pillar_coords(p1, v1, cfg.bev)
    preds_f = [decode(out_fw[i], thr, p0, rc0, v0, occ0 > 0.5, voxel_xy)
               for i in range(cfg.num_iters)]
    preds_b = [decode(out_bw[i], thr, p1, rc1, v1, occ1 > 0.5, voxel_xy)
               for i in range(cfg.num_iters)]
    knn_f = knn_distances(preds_f, p0, v0, p1, v1)
    knn_b = knn_distances(preds_b, p1, v1, p0, v0)
    half = 0.5 * cfg.bev.bev_range_m[0], 0.5 * cfg.bev.bev_range_m[1]
    extent = (-half[0], -half[1], half[0], half[1])
    total, terms, updates = 0.0, None, []
    for i in range(cfg.num_iters):
        terms = iteration_loss(preds_f[i], preds_b[i], knn_f[i], knn_b[i],
                               p0, v0, p1, v1, extent)
        total = total + terms["total_loss"]
        epe_stat = torch.cat([knn_f[i]["static_aggr"][1].sqrt().reshape(-1),
                              knn_b[i]["static_aggr"][1].sqrt().reshape(-1)])
        epe_dyn = torch.cat([knn_f[i]["dynamic"][1].sqrt().reshape(-1),
                             knn_b[i]["dynamic"][1].sqrt().reshape(-1)])
        dyn = torch.cat([preds_f[i]["dynamicness"].reshape(-1),
                         preds_b[i]["dynamicness"].reshape(-1)])
        updates.append((epe_stat.detach(), epe_dyn.detach(), dyn.detach(),
                        torch.cat([v0.reshape(-1), v1.reshape(-1)])))
    flows = (out_fw[-1][..., 4:6].detach(), out_bw[-1][..., 4:6].detach())
    return total, terms, updates, flows


def train_steps(state: dict, batches, cfg: SlimCfg, first_step: int,
                num_train_samples: int, device, kind: str = "fp32",
                corr_vjp: str = "autograd"):
    """The SLIM train step over `batches` [(pcl_t0, valid_t0, pcl_t1,
    valid_t1) numpy] from the model state `state`, RMSprop's nu at 0, the
    threshold at its start, and the step counter at `first_step`. `kind`:
    "fp32" (TF32 off), "tf32" (TF32 on, a control) or "bf16conv" (RAFT's
    convolutions in bf16, a control). Returns {"losses": each step's loss
    and last-iteration terms, "grad": step 1's gradient by leaf, "after":
    the model state and nu ("nu.<leaf>") after the last step, "thr" and
    "importance": the threshold and its improvement histogram after it,
    "flow": step 1's last-iteration flows}."""
    model = RefSlimTrain(cfg, conv_dtype=torch.bfloat16 if kind == "bf16conv"
                         else None, corr_vjp=corr_vjp, device=device)
    model.load_state_dict(state)
    model.train()
    params = dict(model.named_parameters())
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    movavg = movavg_init(num_train_samples, device)
    voxel_xy = voxel_center_coords(cfg.bev, device)
    out = {"losses": []}
    with precision("tf32" if kind == "tf32" else "fp32"):
        for i, arrays in enumerate(batches):
            batch = tuple(torch.from_numpy(a).to(device) for a in arrays)
            for p in params.values():
                p.grad = None
            loss, terms, updates, flows = step_loss(
                model, cfg, batch, movavg_value(movavg), voxel_xy)
            loss.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params.values()]
            if i == 0:
                out["grad"] = {k: g.detach().clone()
                               for k, g in zip(params, grads)}
                out["flow"] = flows
            rmsprop_(list(params.values()), grads, list(nu.values()),
                     lr_at(cfg, first_step + i))
            for u in updates:
                movavg = movavg_update(movavg, *u)
            out["losses"].append(
                {"loss": float(loss.detach()),
                 **{k: float(v.detach()) for k, v in terms.items()}})
            del loss, terms, updates, grads
    out["after"] = {**{k: t.detach().clone()
                       for k, t in model.state_dict().items()},
                    **{f"nu.{k}": v for k, v in nu.items()}}
    out["thr"] = float(movavg_value(movavg))
    out["importance"] = movavg.importance.detach().clone()
    return out


# ---------------------------------------------------------------------------
# the batch, read from the sample files
# ---------------------------------------------------------------------------
def skip_frames(mode: str, seed: int, epoch: int, idx: int) -> bool:
    """Whether the pair of sample `idx` in loader epoch `epoch` is (t0, t2)
    rather than (t0, t1): the skip-frame curriculum ("both": an even draw
    from the sample's own generator, a function of the dataset's seed, the
    epoch and the sample's index)."""
    if mode in ("only", "never"):
        return mode == "only"
    mix = (seed * 1000003 + epoch * 7919 + idx * 2654435761 + 97) % (2**31 - 1)
    return bool(np.random.RandomState(mix).rand() < 0.5)


def _frame(content: dict, tk: str, n_max: int, bev_range_m, height_range):
    """One cloud without its ground, inside the BEV and the pillars' height
    range, padded to n_max."""
    p = np.asarray(content[f"pcl_{tk}"], np.float32)
    g = np.asarray(content[f"is_ground_{tk}"], bool)
    half = 0.5 * np.asarray(bev_range_m, np.float64)
    keep = (~g & (np.abs(p[:, 0]) < half[0]) & (np.abs(p[:, 1]) < half[1])
            & (height_range[0] < p[:, 2]) & (p[:, 2] < height_range[1]))
    out = np.zeros((n_max, p.shape[1]), np.float32)
    k = min(int(keep.sum()), n_max)
    out[:k] = p[keep][:k]
    valid = np.zeros(n_max, bool)
    valid[:k] = True
    return out, valid


def read_flow_batch(files, idxs, epoch: int, seed: int, skip_mode: str,
                    n_max: int, bev_range_m, height_range):
    """The loader's SLIM batch as the reference reads it: per sample its t0
    cloud and its t1 (or, skipping a frame, t2) cloud and the odometry
    between them. Returns numpy (pcl_t0, valid_t0, pcl_t1, valid_t1,
    odom_t0_t1, odom_t1_t0)."""
    cols = [[] for _ in range(6)]
    for f, idx in zip(files, idxs):
        content = np.load(f, allow_pickle=True).item()
        b = "t2" if skip_frames(skip_mode, seed, epoch, idx) else "t1"
        p0, v0 = _frame(content, "t0", n_max, bev_range_m, height_range)
        p1, v1 = _frame(content, b, n_max, bev_range_m, height_range)
        odom = np.asarray(content[f"odom_t0_{b}"], np.float64).astype(np.float32)
        for col, x in zip(cols, (p0, v0, p1, v1, odom,
                                 np.linalg.inv(odom).astype(np.float32))):
            col.append(x)
    return tuple(np.stack(c) for c in cols)
