"""SLIM scene-flow model (port of liso_tpu/models/slim.py): pillar encoder +
RAFT, and the moving-average dynamicness threshold of SLIM training.

The threshold state is a NamedTuple of tensors, carried by the trainer and
replaced (not mutated) by `movavg_update` / `movavg_update_batched`. Its
histogram is the scalar scatter-add kernel K3 (ops/grid_scatter.py
`grid_reduce_add_c1`) over bin-sorted values.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from liso_tpu_torch.models.pillar_encoder import PillarEncoder
from liso_tpu_torch.models.raft import RAFT
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.ops.grid_scatter import grid_reduce_add_c1
from liso_tpu_torch.parallel.mesh import batch_total


# ---------------------------------------------------------------------------
# Moving-average dynamicness threshold
# ---------------------------------------------------------------------------
class MovAvgState(NamedTuple):
    importance: torch.Tensor  # [resolution] fp32 EMA of the improvement hist
    bias_counter: torch.Tensor  # scalar
    update_weight: torch.Tensor  # scalar constant
    start_value: torch.Tensor  # scalar


def movavg_init(num_train_samples: int, num_moving: int = 621_013_971,
                resolution: int = 100_000, start_value: float = 0.5,
                device=None) -> MovAvgState:
    """Update weight such that the buffer turns over roughly every 5k
    iterations."""
    avg_points_per_sample = num_moving / max(num_train_samples, 1)
    update_weight = 1.0 / min(2.0 * num_moving, 5_000.0 * avg_points_per_sample)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return MovAvgState(
        importance=torch.zeros(resolution, dtype=torch.float32, device=device),
        bias_counter=scalar(0.0),
        update_weight=scalar(update_weight),
        start_value=scalar(start_value),
    )


def movavg_value(state: MovAvgState) -> torch.Tensor:
    """Optimal threshold = mean bin index minimising the cumulative
    improvement, over the resolution; the start value until the first
    update."""
    res = state.importance.shape[0]
    improv = torch.cat([state.importance.new_zeros(1),
                        torch.cumsum(state.importance, 0)])
    is_best = improv == improv.min()
    idxs = torch.arange(res + 1, dtype=torch.float32, device=improv.device)
    avg_idx = (idxs * is_best).sum() / is_best.sum().clamp(min=1)
    return torch.where(state.bias_counter > 0.0, avg_idx / res,
                       state.start_value)


def _bins(dynamicness, valid, res):
    bins = (dynamicness * res).to(torch.int32).clamp(0, res - 1)
    return torch.where(valid, bins, res)


def _fold(importance, bias, update_weight, count, hist):
    """One EMA step: (1 - uw)^count via expm1/log1p, exact in fp32 where
    uw ~ 1e-9 would vanish."""
    one_minus_cur_w = -torch.expm1(count * torch.log1p(-update_weight))
    cur_w = 1.0 - one_minus_cur_w
    return (importance * cur_w + one_minus_cur_w * hist,
            bias * cur_w + one_minus_cur_w)


def movavg_update(state: MovAvgState, epes_stat, epes_dyn, dynamicness,
                  valid, group=None) -> MovAvgState:
    """One update from flat [M] inputs: improvements = epe_static -
    epe_dynamic of the valid entries, summed into dynamicness bins, EMA'd
    into the importance."""
    return movavg_update_batched(state, epes_stat[None], epes_dyn[None],
                                 dynamicness[None], valid[None], group)


def _histograms(improvements, bins, res):
    """[I, M] values and bins (res = drop bucket) -> [I, res] per-row bin
    sums: a stable sort of each row by bin, then one K3 launch over all
    rows, with the bins padded to a multiple of 2048 and the drop bucket
    sent to int32 max, as the TPU path does (`liso_tpu/models/slim.py:
    171-183`)."""
    res_pad = -(-res // 2048) * 2048
    bins_s, order = torch.sort(bins, dim=-1, stable=True)
    vals_s = torch.gather(improvements, -1, order)
    bins_s = torch.where(bins_s >= res, torch.iinfo(torch.int32).max, bins_s)
    return grid_reduce_add_c1(vals_s, bins_s, res_pad)[:, :res]


def movavg_update_batched(state: MovAvgState, epes_stat, epes_dyn,
                          dynamicness, valid, group=None) -> MovAvgState:
    """The sequence of `movavg_update` calls over the rows of [I, M] inputs
    (one row per RAFT iteration) with ONE batched histogram pass; the EMA
    folds row by row afterwards. With a process group the [I, res]
    histograms and the valid counts are summed over the ranks (one
    collective) before the fold, which every rank then runs alike."""
    res = state.importance.shape[0]
    n_iter = epes_stat.shape[0]
    improvements = torch.where(valid, epes_stat - epes_dyn, 0.0)
    hists = _histograms(improvements, _bins(dynamicness, valid, res), res)
    counts = valid.sum(-1).float()
    if group is not None:
        summed = batch_total(torch.cat([hists, counts[:, None]], 1), group)
        hists, counts = summed[:, :res], summed[:, res]
    importance, bias = state.importance, state.bias_counter
    for i in range(n_iter):
        importance, bias = _fold(importance, bias, state.update_weight,
                                 counts[i], hists[i])
    return state._replace(importance=importance, bias_counter=bias)


# ---------------------------------------------------------------------------
class SlimModel(nn.Module):
    """forward(pcl_t0, valid_t0, pcl_t1, valid_t1) returns (outputs_fw,
    outputs_bw, occ_t0, occ_t1); outputs_* are [iters, B, H, W, 8(+1)]
    stacked per-iteration network outputs (outputs_bw is None when
    backward=False; the ninth channel is the static-aggregation weight
    logit when `predict_weight_for_static_aggregation` is set). Both
    directions share one RAFT. In train mode (`self.train()`) the pillar
    encoder's batch norm normalises with the batch's statistics and updates
    its running ones, once per frame."""

    def __init__(self, bev: BevSetup, num_iters: int = 6, corr_levels: int = 4,
                 corr_radius: int = 3, pillar_channels: int = 64,
                 point_features: int = 4,
                 predict_weight_for_static_aggregation=False,
                 compute_dtype=None, device=None):
        super().__init__()
        self.bev = bev
        self.compute_dtype = compute_dtype
        self.pillar_encoder = PillarEncoder(
            bev, num_channels=pillar_channels, point_features=point_features,
            scatter_dtype=compute_dtype, device=device,
        )
        self.raft = RAFT(
            bev.grid_size,
            in_channels=pillar_channels,
            num_iters=num_iters,
            corr_levels=corr_levels,
            corr_radius=corr_radius,
            resolution_m=bev.res_m[0],
            predict_weight_for_static_aggregation=(
                predict_weight_for_static_aggregation is not False
            ),
            dtype=compute_dtype,
            device=device,
        )

    def encode_frame(self, pcl, valid, prepared=None, pillar_image=None):
        """Encode ONE frame: (fmap, cnet, occ [B, H, W]). `prepared` skips
        the shared pillar prep; `pillar_image` = (img, occ) skips the
        pillar encoder (the fused step scatters both networks' features in
        one launch)."""
        if pillar_image is not None:
            img, occ = pillar_image
        else:
            img, occ = self.pillar_encoder(pcl, valid, prepared)
        fmap, cn = self.raft.encode(img)
        return fmap, cn, occ[..., 0]

    def pillar_point_feats(self, pcl, valid, prepared=None):
        """Pre-scatter per-point PFN features (x [B, N, C], prepared)."""
        return self.pillar_encoder.point_feats(pcl, valid, prepared=prepared)

    def flow_from_features(self, fmap0, cn0, fmap1, upsample_all=False):
        """Flow frame0 -> frame1 from cached features."""
        return self.raft.flow_from_features(fmap0, cn0, fmap1, upsample_all)

    def forward(self, pcl_t0, valid_t0, pcl_t1, valid_t1,
                backward: bool = True, upsample_all: bool = True):
        img0, occ0 = self.pillar_encoder(pcl_t0, valid_t0)
        img1, occ1 = self.pillar_encoder(pcl_t1, valid_t1)
        outputs_fw = self.raft(img0, img1, upsample_all)
        outputs_bw = self.raft(img1, img0, upsample_all) if backward else None
        return outputs_fw, outputs_bw, occ0[..., 0], occ1[..., 0]
