"""PointPillars feature encoder (port of liso_tpu/models/pillar_encoder.py).

Feature layout matches mmdet3d PillarFeatureNet (with_distance=False):
  [x, y, z, intensity..., x-xm, y-ym, z-zm, x-xc, y-yc]
where (xm, ym, zm) is the pillar mean and (xc, yc) the pillar center. Every
padded point is encoded in place and reduced into the dense BEV image by
the scatter-max kernel (ops/grid_scatter.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from liso_tpu_torch.models.layers import BatchNorm
from liso_tpu_torch.ops import scatter
from liso_tpu_torch.ops.bev import BevSetup, point_cell_ids
from liso_tpu_torch.ops.grid_scatter import grid_scatter_max_occ
from liso_tpu_torch.ops.pillars import pillarize


class PreparedPillars(NamedTuple):
    """Output of prepare_pillar_inputs. grid_size/z_cutoff record the config
    the prep was computed under, so that sharing encoders can check it."""

    feats: torch.Tensor  # [B, N, F+5], cell-sorted
    cell: torch.Tensor  # [B, N] int32 cell ids (sorted)
    in_pillar: torch.Tensor  # [B, N] bool
    grid_size: tuple = ()
    z_cutoff: float = 5.0


class MaskedBatchNorm(BatchNorm):
    """liso_tpu's MaskedBatchNorm over the channels of [..., C] point
    features, in fp32, eps 1e-3. In train mode (`self.training`) the
    statistics are taken over the points where `mask` is set, with the
    biased variance, and the running statistics move with flax's momentum
    0.99 (torch's 0.01): running = 0.99 running + 0.01 batch. In eval mode
    the running statistics normalise. The train statistics are
    `BatchNorm._train_forward_global`'s: the global batch's with a group,
    the local batch's without one."""

    def __init__(self, c: int, eps: float = 1e-3, device=None):
        super().__init__(c, eps=eps, channel_dim=-1, device=device)

    def forward(self, x, mask=None):
        if not self.training:
            return super().forward(x)
        return self._train_forward_global(x, mask)

    def forward_relu(self, x, mask=None):
        if self.training:
            return torch.relu(self(x, mask))
        return super().forward_relu(x)


def prepare_pillar_inputs(
    points: torch.Tensor, valid: torch.Tensor, bev: BevSetup,
    z_cutoff: float = 5.0,
) -> PreparedPillars:
    """Parameter-free pillar input prep shared by every pillar encoder of
    the same cloud: cell ids, a stable sort by cell (the payload columns
    move with the keys, so points within a cell keep their order),
    per-point cluster means and center offsets, feature assembly. Points
    outside any pillar get zero features and the drop-bucket id H*W."""
    h, w = bev.grid_size
    cell_id, in_pillar = pillarize(points, valid, bev, z_cutoff=z_cutoff)
    cell_s, order = torch.sort(cell_id, dim=-1, stable=True)
    f = points.shape[-1]
    pts_s = torch.gather(points, 1, order.unsqueeze(-1).expand(-1, -1, f))
    in_pillar_s = torch.gather(in_pillar, 1, order)

    xyz1 = torch.cat([pts_s[..., :3], torch.ones_like(pts_s[..., :1])], dim=-1)
    totals = scatter.sorted_segment_totals(xyz1, cell_s)
    mean_at_pts = totals[..., :3] / totals[..., 3:].clamp(min=1e-8)
    cluster_off = pts_s[..., :3] - mean_at_pts

    res = torch.tensor(bev.res_m, dtype=points.dtype, device=points.device)
    emin = torch.tensor(bev.extent_min, dtype=points.dtype, device=points.device)
    rc = torch.stack([cell_s // w, cell_s % w], dim=-1).to(points.dtype)
    center_off = pts_s[..., :2] - ((rc + 0.5) * res + emin)
    feats = torch.cat([pts_s, cluster_off, center_off], dim=-1)
    feats = torch.where(in_pillar_s[..., None], feats, 0.0)
    return PreparedPillars(
        feats=feats, cell=cell_s, in_pillar=in_pillar_s,
        grid_size=tuple(bev.grid_size), z_cutoff=float(z_cutoff),
    )


class PillarEncoder(nn.Module):
    """points [B, N, F] + valid [B, N] -> (bev image [B, H, W, C],
    occupancy [B, H, W, 1]). One PFN layer (linear -> masked BN -> ReLU,
    in fp32) and a per-pillar max. `scatter_dtype` is the type the point
    features are scattered in (bf16 when the model computes in bf16)."""

    def __init__(self, bev: BevSetup, num_channels: int = 64,
                 point_features: int = 4, z_cutoff: float = 5.0,
                 scatter_dtype=None, device=None):
        super().__init__()
        self.bev = bev
        self.num_channels = num_channels
        self.z_cutoff = z_cutoff
        self.scatter_dtype = scatter_dtype
        self.pfn_linear = nn.Linear(point_features + 5, num_channels,
                                    bias=False, device=device)
        self.pfn_bn = MaskedBatchNorm(num_channels, device=device)

    def _check_prepared(self, prepared: PreparedPillars):
        if prepared.grid_size != tuple(self.bev.grid_size):
            raise ValueError(
                f"shared pillar prep was computed for grid "
                f"{prepared.grid_size}, encoder expects {tuple(self.bev.grid_size)}"
            )
        if prepared.z_cutoff != float(self.z_cutoff):
            raise ValueError(
                f"shared pillar prep used z_cutoff={prepared.z_cutoff}, "
                f"encoder expects {self.z_cutoff}"
            )

    def point_feats(self, points, valid, prepared=None):
        """Pre-scatter per-point features: (x [B, N, C], prepared)."""
        if prepared is None:
            prepared = prepare_pillar_inputs(
                points, valid, self.bev, z_cutoff=self.z_cutoff
            )
        else:
            self._check_prepared(prepared)
        x = self.pfn_linear(prepared.feats)
        return self.pfn_bn.forward_relu(x, prepared.in_pillar), prepared

    def forward(self, points, valid, prepared=None):
        h, w = self.bev.grid_size
        x, prepared = self.point_feats(points, valid, prepared=prepared)
        if self.scatter_dtype is not None:
            x = x.to(self.scatter_dtype)
        g, occ = grid_scatter_max_occ(x, prepared.cell, self.bev.num_cells)
        b = x.shape[0]
        return g.reshape(b, h, w, self.num_channels), occ.reshape(b, h, w, 1)


def pillar_coords(points: torch.Tensor, valid: torch.Tensor, bev: BevSetup):
    """[B, N, >=2] -> (int32 (row, col) [B, N, 2] per point, clamped in
    range; in-range mask [B, N], False for invalid points)."""
    _, in_range, rc = point_cell_ids(points[..., :2], bev, valid)
    return rc, in_range


def fused_scatter_images(xs, prepared: PreparedPillars, bev: BevSetup,
                         dtype=None):
    """Scatter several encoders' per-point features (same cloud, same prep)
    into BEV images with ONE kernel launch. xs: list of [B, N, Ci]. Returns
    (list of [B, H, W, Ci] images, occupancy [B, H, W, 1])."""
    h, w = bev.grid_size
    b = prepared.cell.shape[0]
    xcat = torch.cat(xs, dim=-1)
    if dtype is not None:
        xcat = xcat.to(dtype)
    g, occ = grid_scatter_max_occ(xcat, prepared.cell, bev.num_cells)
    imgs = []
    off = 0
    for x in xs:
        ci = x.shape[-1]
        imgs.append(g[..., off : off + ci].reshape(b, h, w, ci))
        off += ci
    return imgs, occ.reshape(b, h, w, 1)


def point_feature_mask(points: torch.Tensor, mask) -> torch.Tensor:
    """The reference's `point_feat_mask` channel selection
    (liso_config.yml:322-334) of the augmented features: the channels
    whose flag in `mask` is set."""
    idx = [i for i, m in enumerate(mask) if m]
    return points[..., torch.tensor(idx, device=points.device)]
