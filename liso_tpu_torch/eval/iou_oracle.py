"""Exact host-side rotated-box IoU + NMS oracle, pure numpy in float64
(a copy of liso_tpu/eval/iou_oracle.py; the port imports nothing of the
JAX package).

Port of the reference's CPU exact polygon-clipping IoU
(iou3d_nms/src/iou3d_cpu.cpp:1-252, Sutherland-Hodgman sequential
clipping) and its shapely NMS fallback (liso/utils/nms_iou.py:211). It is
the independent cross-check for the branch-free rotated IoU of
`liso_tpu_torch/ops/iou.py` and `ops/nms.py`: a DIFFERENT algorithm
(sequential convex clipping in float64 against a masked candidate-vertex
shoelace in float32), so agreement between the two is meaningful.

Host/eval use only: nothing here is fast.
"""
from __future__ import annotations

import numpy as np


def box_corners_bev(box5: np.ndarray) -> np.ndarray:
    """[5] (cx, cy, len_x, wid_y, yaw) -> [4, 2] ccw corners (float64)."""
    cx, cy, lx, wy, r = (float(box5[i]) for i in range(5))
    dx = 0.5 * lx * np.array([1.0, -1.0, -1.0, 1.0])
    dy = 0.5 * wy * np.array([1.0, 1.0, -1.0, -1.0])
    c, s = np.cos(r), np.sin(r)
    return np.stack([c * dx - s * dy + cx, s * dx + c * dy + cy], axis=-1)


def _clip_polygon(poly: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman: clip `poly` [P, 2] by the half-plane left of
    the directed edge a->b (iou3d_cpu.cpp clips the subject quad by each
    clip-quad edge in sequence)."""
    if len(poly) == 0:
        return poly
    e = b - a
    # signed area sign: >= 0 means the vertex is on the keep side
    d = e[0] * (poly[:, 1] - a[1]) - e[1] * (poly[:, 0] - a[0])
    out = []
    p = len(poly)
    for i in range(p):
        j = (i + 1) % p
        if d[i] >= 0.0:
            out.append(poly[i])
        if (d[i] >= 0.0) != (d[j] >= 0.0):
            # edge crosses the clip line: add the intersection point
            t = d[i] / (d[i] - d[j])
            out.append(poly[i] + t * (poly[j] - poly[i]))
    return np.asarray(out, np.float64).reshape(-1, 2)


def _polygon_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(
        float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    )


def rotated_intersection_area(box_a5, box_b5) -> float:
    """Exact intersection area of two rotated rectangles (float64)."""
    ca = box_corners_bev(np.asarray(box_a5, np.float64))
    cb = box_corners_bev(np.asarray(box_b5, np.float64))
    poly = ca
    for i in range(4):
        poly = _clip_polygon(poly, cb[i], cb[(i + 1) % 4])
        if len(poly) == 0:
            return 0.0
    return _polygon_area(poly)


def iou_bev(box_a5, box_b5) -> float:
    inter = rotated_intersection_area(box_a5, box_b5)
    area_a = float(box_a5[2]) * float(box_a5[3])
    area_b = float(box_b5[2]) * float(box_b5[3])
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def iou_matrix_bev(pos_a, dims_a, rot_a, pos_b, dims_b, rot_b) -> np.ndarray:
    """[Ka, .] x [Kb, .] -> exact IoU_bev matrix [Ka, Kb] float64."""
    a5 = np.concatenate(
        [np.asarray(pos_a)[:, :2], np.asarray(dims_a)[:, :2],
         np.asarray(rot_a)[:, :1]], axis=-1,
    )
    b5 = np.concatenate(
        [np.asarray(pos_b)[:, :2], np.asarray(dims_b)[:, :2],
         np.asarray(rot_b)[:, :1]], axis=-1,
    )
    out = np.zeros((len(a5), len(b5)), np.float64)
    for i in range(len(a5)):
        for j in range(len(b5)):
            out[i, j] = iou_bev(a5[i], b5[j])
    return out


def iou_matrix_3d(pos_a, dims_a, rot_a, pos_b, dims_b, rot_b) -> np.ndarray:
    """Exact 3D IoU: BEV intersection x z-interval overlap (boxes are
    z-centered, utils/nms_iou.py:150-198)."""
    pos_a, dims_a = np.asarray(pos_a, np.float64), np.asarray(dims_a, np.float64)
    pos_b, dims_b = np.asarray(pos_b, np.float64), np.asarray(dims_b, np.float64)
    out = np.zeros((len(pos_a), len(pos_b)), np.float64)
    for i in range(len(pos_a)):
        a5 = [pos_a[i, 0], pos_a[i, 1], dims_a[i, 0], dims_a[i, 1],
              float(np.asarray(rot_a)[i, 0])]
        for j in range(len(pos_b)):
            b5 = [pos_b[j, 0], pos_b[j, 1], dims_b[j, 0], dims_b[j, 1],
                  float(np.asarray(rot_b)[j, 0])]
            inter_bev = rotated_intersection_area(a5, b5)
            z_ov = max(
                min(pos_a[i, 2] + 0.5 * dims_a[i, 2],
                    pos_b[j, 2] + 0.5 * dims_b[j, 2])
                - max(pos_a[i, 2] - 0.5 * dims_a[i, 2],
                      pos_b[j, 2] - 0.5 * dims_b[j, 2]),
                0.0,
            )
            inter = inter_bev * z_ov
            union = float(np.prod(dims_a[i]) + np.prod(dims_b[j])) - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def nms_keep_mask(
    pos, dims, rot, probs, valid, iou_threshold: float,
    pre_max_boxes: int | None = None, post_max_boxes: int | None = None,
    bev: bool = True,
) -> np.ndarray:
    """Reference-semantics greedy NMS on the host: sort by confidence
    descending (stable), walk in order, suppress any box overlapping an
    already-kept box above `iou_threshold` (iou3d_nms.cpp:60-120 /
    utils/nms_iou.py:79 iou_based_nms with pre/post caps). Returns a bool
    keep mask over the input slots."""
    pos, dims = np.asarray(pos, np.float64), np.asarray(dims, np.float64)
    rot = np.asarray(rot, np.float64)
    probs = np.asarray(probs, np.float64).reshape(len(pos))
    valid = np.asarray(valid, bool).reshape(len(pos))
    order = np.argsort(-probs, kind="stable")
    order = [i for i in order if valid[i]]
    if pre_max_boxes is not None:
        order = order[:pre_max_boxes]
    iou_fn = iou_matrix_bev if bev else iou_matrix_3d
    keep: list[int] = []
    for i in order:
        if post_max_boxes is not None and len(keep) >= post_max_boxes:
            break
        suppressed = False
        for j in keep:
            iou = iou_fn(
                pos[[i]], dims[[i]], rot[[i]], pos[[j]], dims[[j]], rot[[j]]
            )[0, 0]
            if iou > iou_threshold:
                suppressed = True
                break
        if not suppressed:
            keep.append(i)
    mask = np.zeros(len(pos), bool)
    mask[keep] = True
    return mask
