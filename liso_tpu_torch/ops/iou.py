"""Rotated-box BEV / 3D IoU (port of liso_tpu/ops/iou.py).

The exact convex intersection of two rotated rectangles, branch-free over
whole [Ka, Kb] matrices: the candidate vertices are the corners of A inside
B, the corners of B inside A and the 16 edge-edge intersections, masked,
sorted by angle around their centroid, then summed by a masked shoelace.
3D IoU is the BEV overlap times the overlap of the z-intervals (boxes are
z-centered).
"""
from __future__ import annotations

import torch

EPS = 1e-8


def box_corners_bev(boxes_xywlr: torch.Tensor) -> torch.Tensor:
    """[..., 5] (cx, cy, len_x, wid_y, yaw) -> [..., 4, 2] ccw corners."""
    cx, cy, lx, wy, r = boxes_xywlr.unbind(-1)
    dx = torch.stack([lx, -lx, -lx, lx], -1) * 0.5
    dy = torch.stack([wy, wy, -wy, -wy], -1) * 0.5
    c, s = torch.cos(r)[..., None], torch.sin(r)[..., None]
    x = c * dx - s * dy + cx[..., None]
    y = s * dx + c * dy + cy[..., None]
    return torch.stack([x, y], -1)


def _points_in_box(pts: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """pts [..., P, 2] inside rotated box [..., 5] -> [..., P] bool."""
    cx, cy, lx, wy, r = box.unbind(-1)
    c, s = torch.cos(r)[..., None], torch.sin(r)[..., None]
    px = pts[..., 0] - cx[..., None]
    py = pts[..., 1] - cy[..., None]
    u = c * px + s * py
    v = -s * px + c * py
    return ((u.abs() <= 0.5 * lx[..., None] + EPS)
            & (v.abs() <= 0.5 * wy[..., None] + EPS))


def _edge_intersections(ca: torch.Tensor, cb: torch.Tensor):
    """All 16 segment-segment intersections between the edges of two
    quads ca, cb [..., 4, 2]. Returns (pts [..., 16, 2], valid [..., 16])."""
    a0, a1 = ca, torch.roll(ca, -1, dims=-2)
    b0, b1 = cb, torch.roll(cb, -1, dims=-2)
    p = a0[..., :, None, :]  # [..., 4, 4, 2]
    r = (a1 - a0)[..., :, None, :]
    q = b0[..., None, :, :]
    s = (b1 - b0)[..., None, :, :]
    rxs = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = q - p
    parallel = rxs.abs() < EPS
    den = torch.where(parallel, 1.0, rxs)
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) / den
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / den
    ok = (~parallel & (t >= -EPS) & (t <= 1 + EPS) & (u >= -EPS)
          & (u <= 1 + EPS))
    pt = p + t[..., None] * r
    sh = ok.shape[:-2]
    return pt.reshape(sh + (16, 2)), ok.reshape(sh + (16,))


def rotated_intersection_area(box_a: torch.Tensor,
                              box_b: torch.Tensor) -> torch.Tensor:
    """Exact intersection area of rotated rectangles box_a, box_b [..., 5]
    (cx, cy, len, wid, yaw), broadcastable. Returns [...]. The angle sort
    is stable, as JAX's argsort is, and invalid vertices sort last (+inf)."""
    shape = torch.broadcast_shapes(box_a.shape, box_b.shape)
    box_a, box_b = box_a.expand(shape), box_b.expand(shape)
    ca, cb = box_corners_bev(box_a), box_corners_bev(box_b)
    in_b = _points_in_box(ca, box_b)  # [..., 4]
    in_a = _points_in_box(cb, box_a)
    ei, ei_ok = _edge_intersections(ca, cb)  # [..., 16, 2], [..., 16]

    pts = torch.cat([ca, cb, ei], dim=-2)  # [..., 24, 2]
    ok = torch.cat([in_b, in_a, ei_ok], dim=-1)  # [..., 24]
    n = ok.sum(-1)
    okf = ok[..., None].to(pts.dtype)
    centroid = (pts * okf).sum(-2) / n[..., None].clamp(min=1).to(pts.dtype)
    d = pts - centroid[..., None, :]
    ang = torch.where(ok, torch.atan2(d[..., 1], d[..., 0]), torch.inf)
    order = torch.argsort(ang, dim=-1, stable=True)
    sp = torch.gather(pts, -2, order[..., None].expand(*order.shape, 2))
    so = torch.gather(ok, -1, order)

    idx = torch.arange(pts.shape[-2], device=pts.device)
    nxt = torch.where(idx + 1 < n[..., None], idx + 1, 0)
    sp_next = torch.gather(sp, -2, nxt[..., None].expand(*nxt.shape, 2))
    cross = sp[..., 0] * sp_next[..., 1] - sp[..., 1] * sp_next[..., 0]
    cross = torch.where(so & (idx < n[..., None]), cross, 0.0)
    area = 0.5 * cross.sum(-1).abs()
    return torch.where(n >= 3, area, 0.0)


def _as_bev5(pos, dims, rot):
    return torch.cat([pos[..., :2], dims[..., :2], rot[..., :1]], dim=-1)


def _mask(iou, valid_a, valid_b):
    if valid_a is not None:
        iou = torch.where(valid_a[:, None], iou, 0.0)
    if valid_b is not None:
        iou = torch.where(valid_b[None, :], iou, 0.0)
    return iou


def iou_matrix_bev(pos_a, dims_a, rot_a, pos_b, dims_b, rot_b,
                   valid_a=None, valid_b=None) -> torch.Tensor:
    """[Ka, ...] x [Kb, ...] -> BEV IoU [Ka, Kb]; invalid rows and columns
    read 0."""
    a = _as_bev5(pos_a, dims_a, rot_a)
    b = _as_bev5(pos_b, dims_b, rot_b)
    inter = rotated_intersection_area(a[:, None, :], b[None, :, :])
    area_a = (dims_a[..., 0] * dims_a[..., 1])[:, None]
    area_b = (dims_b[..., 0] * dims_b[..., 1])[None, :]
    iou = inter / (area_a + area_b - inter).clamp(min=EPS)
    return _mask(iou, valid_a, valid_b)


def iou_matrix_3d(pos_a, dims_a, rot_a, pos_b, dims_b, rot_b,
                  valid_a=None, valid_b=None) -> torch.Tensor:
    """3D IoU [Ka, Kb]: BEV overlap x z-interval overlap."""
    a = _as_bev5(pos_a, dims_a, rot_a)
    b = _as_bev5(pos_b, dims_b, rot_b)
    inter_bev = rotated_intersection_area(a[:, None, :], b[None, :, :])
    za_lo = pos_a[:, 2] - 0.5 * dims_a[:, 2]
    za_hi = pos_a[:, 2] + 0.5 * dims_a[:, 2]
    zb_lo = pos_b[:, 2] - 0.5 * dims_b[:, 2]
    zb_hi = pos_b[:, 2] + 0.5 * dims_b[:, 2]
    z_ov = (torch.minimum(za_hi[:, None], zb_hi[None, :])
            - torch.maximum(za_lo[:, None], zb_lo[None, :])).clamp(min=0.0)
    inter = inter_bev * z_ov
    vol_a = dims_a.prod(-1)[:, None]
    vol_b = dims_b.prod(-1)[None, :]
    iou = inter / (vol_a + vol_b - inter).clamp(min=EPS)
    return _mask(iou, valid_a, valid_b)
