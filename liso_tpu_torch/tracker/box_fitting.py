"""2D rotated-rectangle fitting to point clusters (port of
liso_tpu/tracker/box_fitting.py).

Behavioral reference: liso/box_fitting/box_fitting.py:10-258 (MODEST-derived
fits). Every method is a masked sweep over candidate angles, evaluated in
one shot on the points' device:

  * closeness_to_edge (default, delta 5 deg -> 19 angles): maximise
    sum(1 / max(min(dist_to_edge_x, dist_to_edge_y), d0))
  * variance_to_edge: minimise the variance of the closest-edge distances
  * min_area: minimise the bounding rectangle's area (a 1 deg sweep)
  * pca: the principal component's direction

Each returns (center_xy [2], length, width, yaw) of the fitted rectangle.
"""
from __future__ import annotations

import math

import torch

BIG = 1e9


def _sweep_stats(pts: torch.Tensor, mask: torch.Tensor, angles: torch.Tensor):
    """Project [N, 2] pts into each angle's frame: per angle (min_x, max_x,
    min_y, max_y) and the projections px, py [A, N]."""
    c, s = torch.cos(angles), torch.sin(angles)
    # rows of the rotation [[c, s], [-s, c]]
    px = c[:, None] * pts[None, :, 0] + s[:, None] * pts[None, :, 1]
    py = -s[:, None] * pts[None, :, 0] + c[:, None] * pts[None, :, 1]
    big = torch.where(mask[None], 0.0, BIG)
    return ((px + big).amin(1), (px - big).amax(1), (py + big).amin(1),
            (py - big).amax(1), px, py)


def _extents(pts, mask, a):
    c, s = torch.cos(a), torch.sin(a)
    px = c * pts[:, 0] + s * pts[:, 1]
    py = -s * pts[:, 0] + c * pts[:, 1]
    big = torch.where(mask, 0.0, BIG)
    return (px + big).amin(), (px - big).amax(), (py + big).amin(), (py - big).amax()


def _finalize(pts, mask, angle):
    """Extents at the chosen angle, turned by pi/2 when the x extent is the
    shorter, so that length >= width."""
    mnx, mxx, mny, mxy = _extents(pts, mask, angle)
    angle = torch.where((mxx - mnx) < (mxy - mny), angle + math.pi / 2, angle)
    mnx, mxx, mny, mxy = _extents(pts, mask, angle)
    cx_p = 0.5 * (mnx + mxx)
    cy_p = 0.5 * (mny + mxy)
    c, s = torch.cos(angle), torch.sin(angle)
    # unproject the center: p = R(angle) x with R = [[c, s], [-s, c]]
    center = torch.stack([c * cx_p - s * cy_p, s * cx_p + c * cy_p])
    return center, mxx - mnx, mxy - mny, angle


def _angles(stop_deg: float, delta_deg: float, device):
    """jnp.deg2rad(jnp.arange(0, stop, delta)) in fp32."""
    return torch.deg2rad(torch.arange(0.0, stop_deg, delta_deg,
                                      dtype=torch.float32, device=device))


def fit_2d_box(pts_xy: torch.Tensor, mask: torch.Tensor,
               method: str = "closeness_to_edge", delta_deg: float = 5.0,
               d0: float = 1e-2):
    """Returns (center [2], length, width, yaw). Meaningless with fewer
    than 2 masked points (the caller checks)."""
    if method == "pca":
        m = mask.to(torch.float32)
        cnt = m.sum().clamp(min=1.0)
        mean = (pts_xy * m[:, None]).sum(0) / cnt
        d = (pts_xy - mean) * m[:, None]
        cov = d.T @ d / cnt
        tr = cov[0, 0] + cov[1, 1]
        det = cov[0, 0] * cov[1, 1] - cov[0, 1] ** 2
        disc = torch.sqrt((0.25 * tr * tr - det).clamp(min=0.0))
        l1 = 0.5 * tr + disc
        return _finalize(pts_xy, mask, torch.atan2(l1 - cov[0, 0], cov[0, 1] + 1e-12))

    if method in ("closeness_to_edge", "variance_to_edge"):
        angles = _angles(90.0 + delta_deg, delta_deg, pts_xy.device)
        mnx, mxx, mny, mxy, px, py = _sweep_stats(pts_xy, mask, angles)
        dx = torch.minimum(px - mnx[:, None], mxx[:, None] - px)
        dy = torch.minimum(py - mny[:, None], mxy[:, None] - py)
        if method == "closeness_to_edge":
            beta = 1.0 / torch.minimum(dx, dy).clamp(min=d0)
            score = torch.where(mask[None], beta, 0.0).sum(1)
        else:
            def masked_var(v, m):
                cnt = m.sum(1).clamp(min=1).to(v.dtype)
                mean = torch.where(m, v, 0.0).sum(1) / cnt
                var = torch.where(m, (v - mean[:, None]) ** 2, 0.0).sum(1) / cnt
                return torch.where(m.any(1), var, 0.0)

            score = -(masked_var(dx, (dx < dy) & mask[None])
                      + masked_var(dy, (dy < dx) & mask[None]))
        best = torch.argmax(score)
    elif method == "min_area":
        angles = _angles(90.0, 1.0, pts_xy.device)
        mnx, mxx, mny, mxy, _, _ = _sweep_stats(pts_xy, mask, angles)
        best = torch.argmin((mxx - mnx) * (mxy - mny))
    else:
        raise ValueError(method)
    return _finalize(pts_xy, mask, angles[best])
