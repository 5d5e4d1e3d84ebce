"""Clustering of the thresholded dynamicness grid for the flow-cluster
bootstrap detector (port of liso_tpu/ops/clustering.py).

The mask is dilated `dilation` times by a 3x3 max (DBSCAN's eps-ball
connectivity), labels live on the original mask cells, and min-label
propagation over the 8-neighbourhood runs to its fixpoint, at most
`max_iters` propagations after the first, as the JAX `lax.while_loop`
does. Per-label statistics (centroid, orientation and axis lengths, as
skimage's regionprops defines them) come from second moments.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

# propagations between two convergence checks: each check is a host sync,
# and a propagation past the fixpoint changes nothing
CHECK_EVERY = 16


def _dilate(mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """3x3 binary dilation, `iterations` times: a max with -inf padding
    and SAME output size, as `reduce_window` max is in JAX."""
    m = mask.to(torch.float32)[None, None]
    for _ in range(iterations):
        m = F.max_pool2d(m, 3, stride=1, padding=1)
    return m[0, 0] > 0.5


def connected_components(mask: torch.Tensor, dilation: int = 2,
                         max_iters: int = 256) -> torch.Tensor:
    """[H, W] bool -> int32 labels [H, W]: 0 is background, a cluster gets
    the smallest flat index of its cells + 1. Connectivity is the
    8-neighbourhood through the dilated mask; labels are reported on the
    original mask cells only.

    The JAX loop checks `any(labels != prev)` after every propagation; here
    the check runs every CHECK_EVERY propagations (a host sync each).
    A converged label map is a fixpoint, so the propagations past it change
    nothing, and the count is capped exactly as in JAX: one propagation
    from the initial labels, then at most `max_iters` more."""
    h, w = mask.shape
    big = h * w
    grown = _dilate(mask, dilation) if dilation > 0 else mask
    init = torch.where(
        grown,
        torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(h, w),
        torch.tensor(big, dtype=torch.int32, device=mask.device),
    )

    def propagate(labels):
        # CUDA's max_pool2d takes no int32: a min over 9 shifted views
        p = F.pad(labels, (1, 1, 1, 1), value=big)
        best = labels
        for dr in range(3):
            for dc in range(3):
                if (dr, dc) != (1, 1):
                    best = torch.minimum(best, p[dr:dr + h, dc:dc + w])
        return torch.where(grown, best, labels)

    labels = propagate(init)
    done = 0
    while done < max_iters:
        n = min(CHECK_EVERY, max_iters - done)
        for _ in range(n):
            prev, labels = labels, propagate(labels)
        done += n
        if torch.equal(labels, prev):
            break
    return torch.where(mask, labels + 1, 0)


class ClusterStats(NamedTuple):
    centroid_rc: torch.Tensor  # [K, 2] float cell coords
    orientation: torch.Tensor  # [K] major-axis angle vs the row axis
    axis_major: torch.Tensor  # [K] cells (regionprops axis_major_length)
    axis_minor: torch.Tensor  # [K]
    count: torch.Tensor  # [K] int
    valid: torch.Tensor  # [K] bool


def cluster_stats(labels: torch.Tensor, k_max: int = 64) -> ClusterStats:
    """The k_max clusters of smallest label with regionprops-style moments
    (centroid, orientation, axis lengths)."""
    h, w = labels.shape
    dev = labels.device
    flat = labels.reshape(-1)
    present = flat > 0
    # label runs of the sorted labels; background sorts last
    order = torch.argsort(torch.where(present, flat, h * w + 1), stable=True)
    sorted_lab = flat[order]
    is_start = torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev),
        sorted_lab[1:] != sorted_lab[:-1],
    ]) & (sorted_lab <= h * w)
    # jnp.nonzero(is_start, size=k_max, fill_value=h*w): the first k_max
    # run starts, padded with h*w, placed by their rank (no host sync)
    rank = torch.cumsum(is_start.to(torch.int32), 0) - 1
    slot = torch.where(is_start & (rank < k_max), rank, k_max).long()
    start_idx = torch.full((k_max + 1,), h * w, dtype=torch.long, device=dev)
    start_idx.scatter_(0, slot, torch.arange(h * w, device=dev))
    start_idx = start_idx[:k_max]
    cluster_label = torch.where(
        start_idx < h * w, sorted_lab[start_idx.clamp(0, h * w - 1)], -1)
    valid = cluster_label > 0

    # membership one-hot against the selected labels; moments in fp32
    member = (flat[None, :] == cluster_label[:, None]) & present[None, :]
    cnt = member.sum(-1)
    idx = torch.arange(h * w, dtype=torch.float32, device=dev)
    rr = torch.div(idx, w, rounding_mode="floor")
    cc = torch.remainder(idx, w)
    mf = member.to(torch.float32)
    denom = cnt.clamp(min=1).to(torch.float32)
    mr = (mf * rr).sum(-1) / denom
    mc = (mf * cc).sum(-1) / denom
    dr = rr[None] - mr[:, None]
    dc = cc[None] - mc[:, None]
    mu_rr = (mf * dr * dr).sum(-1) / denom + 1.0 / 12.0
    mu_cc = (mf * dc * dc).sum(-1) / denom + 1.0 / 12.0
    mu_rc = (mf * dr * dc).sum(-1) / denom
    # eigenvalues of [[mu_rr, mu_rc], [mu_rc, mu_cc]]
    tr = mu_rr + mu_cc
    det = mu_rr * mu_cc - mu_rc * mu_rc
    disc = torch.sqrt((0.25 * tr * tr - det).clamp(min=0.0))
    l1 = 0.5 * tr + disc
    l2 = 0.5 * tr - disc
    return ClusterStats(
        centroid_rc=torch.stack([mr, mc], -1),
        orientation=0.5 * torch.atan2(2.0 * mu_rc, mu_rr - mu_cc),
        axis_major=4.0 * torch.sqrt(l1.clamp(min=0.0)),
        axis_minor=4.0 * torch.sqrt(l2.clamp(min=0.0)),
        count=cnt,
        valid=valid & (cnt > 0),
    )
