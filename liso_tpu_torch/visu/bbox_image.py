"""BEV renderings: point-cloud occupancy + rotated box wireframes + GIFs.

Behavioral reference: liso/visu/{bbox_image.py, pcl_image.py} and the
animated-GIF track summaries of liso/tracker/tracking.py:365-500. Pure
numpy rasterisation (Bresenham lines), PIL for GIF encoding.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


def pcl_occupancy_image(
    pcl_xy: np.ndarray, bev_range_m, grid_hw, background=0.0
) -> np.ndarray:
    """[N, 2] points -> float [H, W] occupancy."""
    h, w = grid_hw
    res = np.array([bev_range_m[0] / h, bev_range_m[1] / w])
    rc = np.floor(
        (pcl_xy + 0.5 * np.asarray(bev_range_m)) / res
    ).astype(int)
    ok = (rc[:, 0] >= 0) & (rc[:, 0] < h) & (rc[:, 1] >= 0) & (rc[:, 1] < w)
    img = np.full((h, w), background, np.float32)
    img[rc[ok, 0], rc[ok, 1]] = 1.0
    return img


def _draw_line(img: np.ndarray, p0, p1, color):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    rr = np.linspace(p0[0], p1[0], n).round().astype(int)
    cc = np.linspace(p0[1], p1[1], n).round().astype(int)
    h, w = img.shape[:2]
    ok = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
    img[rr[ok], cc[ok]] = color


def draw_boxes_bev(
    img_rgb: np.ndarray,  # [H, W, 3] float 0..1 (modified in place)
    boxes: Dict[str, np.ndarray],  # pos/dims/rot arrays (valid-only)
    bev_range_m,
    color=(0.0, 1.0, 0.0),
) -> np.ndarray:
    """color: one RGB triple, or a [K, 3] per-box array (reference
    draw_box_onto_image accepts per-box colors, bbox_image.py:186)."""
    h, w = img_rgb.shape[:2]
    res = np.array([bev_range_m[0] / h, bev_range_m[1] / w])
    per_box = np.asarray(color, np.float32)
    k_total = len(boxes["pos"])
    if per_box.ndim == 1:
        per_box = np.broadcast_to(per_box, (k_total, 3))
    for k in range(k_total):
        cx, cy = boxes["pos"][k, :2]
        lx, wy = boxes["dims"][k, :2] * 0.5
        yaw = boxes["rot"][k, 0]
        c, s = np.cos(yaw), np.sin(yaw)
        corners = np.array(
            [[lx, wy], [-lx, wy], [-lx, -wy], [lx, -wy]]
        ) @ np.array([[c, s], [-s, c]]) + np.array([cx, cy])
        rc = (corners + 0.5 * np.asarray(bev_range_m)) / res
        for i in range(4):
            _draw_line(img_rgb, rc[i], rc[(i + 1) % 4], per_box[k])
        # heading tick from center to front edge midpoint
        front = 0.5 * (rc[0] + rc[3])
        center = (np.array([cx, cy]) + 0.5 * np.asarray(bev_range_m)) / res
        _draw_line(img_rgb, center, front, per_box[k])
    return img_rgb


def _summer(v: np.ndarray) -> np.ndarray:
    """matplotlib 'summer' colormap (r=v, g=0.5+v/2, b=0.4) without the
    matplotlib dependency."""
    v = np.clip(np.asarray(v, np.float32), 0.0, 1.0)
    return np.stack([v, 0.5 + 0.5 * v, 0.4 * np.ones_like(v)], axis=-1)


def _boxes_at(boxes: Dict[str, np.ndarray], i: int) -> Dict[str, np.ndarray]:
    """Batch element i of a padded batched box dict, valid rows only."""
    v = np.asarray(boxes["valid"][i], bool)
    return {k: np.asarray(x[i])[v] for k, x in boxes.items() if k != "valid"}


def attribute_colored_box_image(
    canvas_gray: np.ndarray,  # [B, H, W] float 0..1 occupancy
    pred_boxes: Dict[str, np.ndarray],  # batched padded dict (with 'valid')
    per_box_scalar: np.ndarray,  # [B, K]
    bev_range_m,
    gt_boxes: Optional[Dict[str, np.ndarray]] = None,
) -> np.ndarray:
    """GT wireframes in red, predictions colored by their min-max-normalized
    scalar through the 'summer' colormap (reference
    attribute_colored_box_image, bbox_image.py:431-466). Returns
    [B, H, W, 3]."""
    b = canvas_gray.shape[0]
    scal = np.array(per_box_scalar, np.float32)
    valid = np.asarray(pred_boxes["valid"], bool)
    if valid.any():
        lo = scal[valid].min()
        hi = scal[valid].max()
        norm = (scal - lo) / max(hi - lo, 1e-6)
    else:
        norm = np.full_like(scal, 0.5)
    colors = _summer(norm)
    out = np.repeat(canvas_gray[..., None].astype(np.float32), 3, axis=-1)
    for i in range(b):
        if gt_boxes is not None:
            draw_boxes_bev(
                out[i], _boxes_at(gt_boxes, i), bev_range_m,
                color=(1.0, 0.0, 0.0),
            )
        v = valid[i]
        draw_boxes_bev(
            out[i],
            {k: np.asarray(x[i])[v] for k, x in pred_boxes.items()
             if k != "valid"},
            bev_range_m,
            color=colors[i][v],
        )
    return out


def plot_per_box_text_on_canvas(
    *,
    bev_range_m,
    pred_boxes: Dict[str, np.ndarray],  # batched padded dict
    per_obj_scalar: np.ndarray,  # [B, K]
    target_canvas: np.ndarray,  # [B, H, W, 3] float 0..1
    max_num_images: int = 8,
) -> np.ndarray:
    """Stamp each valid box's scalar (scientific, 1 digit) at its BEV pixel
    (reference plot_per_box_text_on_canvas, bbox_image.py:468-510)."""
    from PIL import Image, ImageDraw

    h, w = target_canvas.shape[1:3]
    res = np.array([bev_range_m[0] / h, bev_range_m[1] / w])
    scal = np.asarray(per_obj_scalar)
    valid = np.asarray(pred_boxes["valid"], bool)
    pos = np.asarray(pred_boxes["pos"])
    canvii = []
    for i in range(min(max_num_images, target_canvas.shape[0])):
        canvas = Image.fromarray(
            (255.0 * np.clip(target_canvas[i], 0, 1)).astype(np.uint8)
        )
        draw = ImageDraw.Draw(canvas)
        for k in np.flatnonzero(valid[i]):
            rc = (pos[i, k, :2] + 0.5 * np.asarray(bev_range_m)) / res
            draw.text(
                (float(rc[1]), float(rc[0])),
                np.format_float_scientific(scal[i, k], precision=1),
                fill=(255, 1, 154),
            )
        canvii.append(np.asarray(canvas, np.float32) / 255.0)
    return np.stack(canvii)


def scalar_colored_box_img_w_text(
    canvas_gray: np.ndarray,
    pred_boxes: Dict[str, np.ndarray],
    per_obj_scalar: np.ndarray,
    bev_range_m,
    gt_boxes: Optional[Dict[str, np.ndarray]] = None,
    max_num_images: int = 8,
) -> np.ndarray:
    """Scalar-colored wireframes + per-box scalar text (reference
    scalar_colored_box_img_w_text, bbox_image.py:405-429)."""
    rgb = attribute_colored_box_image(
        canvas_gray, pred_boxes, per_obj_scalar, bev_range_m,
        gt_boxes=gt_boxes,
    )
    return plot_per_box_text_on_canvas(
        bev_range_m=bev_range_m,
        pred_boxes=pred_boxes,
        per_obj_scalar=per_obj_scalar,
        target_canvas=rgb,
        max_num_images=max_num_images,
    )


def _top_conf(boxes: Dict[str, np.ndarray], i: int, cap: int):
    """Batch element i, valid rows, confidence-descending, capped."""
    flat = _boxes_at(boxes, i)
    if "probs" in flat and len(flat["pos"]):
        order = np.argsort(-flat["probs"][:, 0])[:cap]
        flat = {k: v[order] for k, v in flat.items()}
    return flat


def log_box_movement(
    *,
    writer,
    tag: str,
    global_step: int,
    pcl_t0: np.ndarray,  # [B, N, >=2] (valid points)
    pred_boxes: Dict[str, np.ndarray],  # batched padded
    gt_boxes: Optional[Dict[str, np.ndarray]],
    bev_range_m,
    pcl_t1: Optional[np.ndarray] = None,
    gt_boxes_t1: Optional[Dict[str, np.ndarray]] = None,
    grid_hw=(512, 512),
    max_num_images: int = 4,
) -> np.ndarray:
    """Reconstruction-target image panel (reference log_box_movement,
    bbox_image.py:611-666): [preds@100-cap | preds@40-cap | t1 GT] stacked
    along H, GT red / preds green, logged as one image per batch element."""
    panels = []
    b = len(pred_boxes["valid"])
    for i in range(min(b, max_num_images)):
        cols = []
        for cap in (100, 40):
            img = render_frame(
                np.asarray(pcl_t0[i])[:, :2], None, bev_range_m, grid_hw
            )
            if gt_boxes is not None:
                draw_boxes_bev(
                    img, _boxes_at(gt_boxes, i), bev_range_m, (1.0, 0.0, 0.0)
                )
            draw_boxes_bev(
                img, _top_conf(pred_boxes, i, cap), bev_range_m,
                (0.0, 1.0, 0.0),
            )
            cols.append(img)
        if pcl_t1 is not None and gt_boxes_t1 is not None:
            img = render_frame(
                np.asarray(pcl_t1[i])[:, :2], None, bev_range_m, grid_hw
            )
            draw_boxes_bev(
                img, _boxes_at(gt_boxes_t1, i), bev_range_m, (1.0, 0.0, 0.0)
            )
            cols.append(img)
        panels.append(np.concatenate(cols, axis=0))
    panel = np.stack(panels)
    if writer is not None:
        for i, img in enumerate(panel):
            writer.add_image(f"{tag}/b{i}", img, global_step)
    return panel


def render_gt_boxes_with_predicted_logits(
    prob_map: np.ndarray,  # [B, H, W, 1] predicted confidence map
    gt_boxes: Dict[str, np.ndarray],  # batched padded
    canvas_gray: np.ndarray,  # [B, H, W]
    bev_range_m,
    max_num_images: int = 8,
) -> np.ndarray:
    """GT boxes colored + labeled by the detector's confidence at their
    center pixel (reference render_gt_boxes_with_predicted_logits,
    bbox_image.py:668-711) — shows whether the heatmap fires on GT."""
    b, h, w = prob_map.shape[:3]
    res = np.array([bev_range_m[0] / h, bev_range_m[1] / w])
    pos = np.asarray(gt_boxes["pos"])
    rc = np.floor(
        (pos[..., :2] + 0.5 * np.asarray(bev_range_m)) / res
    ).astype(int)
    rr = np.clip(rc[..., 0], 0, h - 1)
    cc = np.clip(rc[..., 1], 0, w - 1)
    bidx = np.arange(b)[:, None]
    probs_at_gt = np.asarray(prob_map)[bidx, rr, cc, 0]
    return scalar_colored_box_img_w_text(
        canvas_gray,
        gt_boxes,
        probs_at_gt,
        bev_range_m,
        max_num_images=max_num_images,
    )


def render_frame(
    pcl_xy: np.ndarray,
    boxes: Optional[Dict[str, np.ndarray]],
    bev_range_m,
    grid_hw=(512, 512),
    box_color=(0.0, 1.0, 0.0),
) -> np.ndarray:
    occ = pcl_occupancy_image(pcl_xy, bev_range_m, grid_hw)
    img = np.stack([occ * 0.6] * 3, -1)
    if boxes is not None and len(boxes["pos"]):
        draw_boxes_bev(img, boxes, bev_range_m, box_color)
    return img


def save_tracking_gif(
    frames: List[np.ndarray],  # list of [H, W, 3] float 0..1
    path,
    fps: int = 5,
) -> Path:
    """Animated GIF of a tracked sequence (tracking.py:417-473 writes these
    into TB as protobuf image summaries; a GIF on disk is the portable
    equivalent and can also be logged)."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    imgs = [
        Image.fromarray((np.clip(f, 0, 1) * 255).astype(np.uint8))
        for f in frames
    ]
    imgs[0].save(
        path, save_all=True, append_images=imgs[1:],
        duration=int(1000 / fps), loop=0,
    )
    return path


# ---------------------------------------------------------------------------
# Range-image rendering (reference visu/bbox_image.py:19-152, consumed by
# slim/experiment.py:729-770 image summaries)
# ---------------------------------------------------------------------------
def range_project_points(
    pcl: np.ndarray,
    elevation_rad_max: float,
    elevation_rad_min: float,
    height: int,
    width: int,
):
    """[N, >=3] -> (row_idx, col_idx) int arrays on a spherical range
    image (elevation rows, azimuth columns)."""
    d_xy = np.linalg.norm(pcl[..., :2], axis=-1)
    elev = np.arctan2(pcl[..., 2], d_xy)
    elev_n = 1.0 - (
        np.clip(elev, elevation_rad_min, elevation_rad_max) - elevation_rad_min
    ) / (elevation_rad_max - elevation_rad_min)
    rows = np.clip(elev_n * height, 0, height - 1).astype(np.int32)
    azim = np.arctan2(pcl[..., 1], pcl[..., 0])
    cols = np.clip(
        (azim + np.pi) / (2 * np.pi) * width, 0, width - 1
    ).astype(np.int32)
    return rows, cols


def _rainbow(v: np.ndarray) -> np.ndarray:
    """Minimal gist_rainbow-style colormap (no matplotlib dependency)."""
    v = np.clip(v, 0.0, 1.0)
    h = (1.0 - v) * 0.8  # red -> violet
    i = (h * 6.0).astype(np.int32) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    one = np.ones_like(f)
    lut = np.stack(
        [
            np.stack([one, f, 0 * f], -1),
            np.stack([1 - f, one, 0 * f], -1),
            np.stack([0 * f, one, f], -1),
            np.stack([0 * f, 1 - f, one], -1),
            np.stack([f, 0 * f, one], -1),
            np.stack([one, 0 * f, one], -1),
        ],
        axis=0,
    )
    return lut[i, np.arange(len(v))]


def render_pcl_range_image(
    pcls,
    elevation_rad_max: float = np.deg2rad(4.0),
    elevation_rad_min: float = np.deg2rad(-25.0),
    height: int = 128,
    width: int = 1024,
) -> np.ndarray:
    """List of [N, 3|4] clouds -> [B, H, W, 3] float images; color by
    intensity when available, else by normalized range."""
    out = np.zeros((len(pcls), height, width, 3), np.float32)
    for b, pcl in enumerate(pcls):
        pcl = np.asarray(pcl)
        if len(pcl) == 0:
            continue
        if pcl.shape[-1] >= 4:
            color = _rainbow(pcl[:, 3])
        else:
            rng_m = np.linalg.norm(pcl[:, :3], axis=-1)
            span = max(rng_m.max() - rng_m.min(), 1e-6)
            color = _rainbow((rng_m - rng_m.min()) / span)
        rows, cols = range_project_points(
            pcl, elevation_rad_max, elevation_rad_min, height, width
        )
        out[b, rows, cols] = color
    return out


def draw_boxes_on_range_image(
    img: np.ndarray,
    boxes: dict,
    elevation_rad_max: float = np.deg2rad(4.0),
    elevation_rad_min: float = np.deg2rad(-25.0),
    color=(1.0, 1.0, 1.0),
) -> np.ndarray:
    """Project each box's 8 corners into the range image and draw the
    wireframe (reference draw_boxes_on_2d_projection:96-152). boxes: flat
    dict with pos/dims/rot (+ optional valid)."""
    img = img.copy()
    h, w = img.shape[:2]
    valid = np.asarray(
        boxes.get("valid", np.ones(len(boxes["pos"]), bool))
    ).reshape(-1)
    edges = [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ]
    for i in np.flatnonzero(valid):
        c = boxes["pos"][i]
        d = boxes["dims"][i]
        yaw = float(np.reshape(boxes["rot"][i], (-1,))[0])
        sx, sy, sz = d / 2.0
        corners = np.array(
            [
                [sx, sy, -sz], [sx, -sy, -sz], [-sx, -sy, -sz], [-sx, sy, -sz],
                [sx, sy, sz], [sx, -sy, sz], [-sx, -sy, sz], [-sx, sy, sz],
            ]
        )
        ca, sa = np.cos(yaw), np.sin(yaw)
        R = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
        pts = corners @ R.T + c
        rows, cols = range_project_points(
            pts, elevation_rad_max, elevation_rad_min, h, w
        )
        for a, b_ in edges:
            n = 32
            rr = np.linspace(rows[a], rows[b_], n).astype(np.int32)
            cc = np.linspace(cols[a], cols[b_], n).astype(np.int32)
            if np.abs(cols[a] - cols[b_]) > w // 2:
                continue  # edge wraps around the azimuth seam
            img[np.clip(rr, 0, h - 1), np.clip(cc, 0, w - 1)] = color
    return img
