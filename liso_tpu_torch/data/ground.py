"""JCP/RECM range-image ground segmentation, vectorised numpy.

Behavioral reference: liso/jcp/jcp.py:8-394 (numba reimplementation of the
JPC paper used by the offline ETL). Same three stages:

  1. range projection: azimuth -> column, normalised elevation -> row, one
     representative point per cell, per-(column, range-region) min z;
  2. RECM: fill/smooth the region min-z profile per column, clamp its slope
     to tan(sigma)=7deg outward, mark cells >= min_z + 0.3 m as obstacle;
  3. JCP boundary refinement: dilate the obstacle channel, re-vote boundary
     cells from their 24 3D-nearest neighbors (exp(-5*range_diff) weights).

The numba per-point loops become scatter-min / cumulative ops; the JCP pass
is swept a fixed number of iterations instead of the reference's in-place
sequential scan (same fixpoint on boundary blobs).
"""
from __future__ import annotations

import numpy as np

MIN_RANGE = 3.0
MAX_RANGE = 70.0
TH_G = 0.3
SIGMA_DEG = 7.0

OBSTACLE, GROUND, EMPTY = 2, 1, 0


def jpc_ground_remove(
    pcl: np.ndarray,
    range_img_width: int = 2083,
    range_img_height: int = 64,
    sensor_height: float = -1.73,
    delta_r: float = 2.0,
    jcp_iterations: int = 1,
) -> np.ndarray:
    """[N, >=3] -> bool is_ground per point."""
    pts = pcl[:, :3]
    n = len(pts)
    length = int((MAX_RANGE - MIN_RANGE) / delta_r)

    az = np.arctan2(pts[:, 1], pts[:, 0])
    az = np.where(pts[:, 1] < 0, az + 2 * np.pi, az)
    rng_xy = np.linalg.norm(pts[:, :2], axis=-1)
    ele = np.arcsin(np.clip(pts[:, 2] / np.maximum(rng_xy, 1e-6), -1, 1))
    fin = np.isfinite(ele)
    lo, hi = ele[fin].min(), ele[fin].max()
    row = np.clip(
        (range_img_height * (ele - lo) / max(hi - lo, 1e-6)).astype(np.int32),
        0,
        range_img_height - 1,
    )
    col = ((range_img_width - 1) * np.rad2deg(az) / 360.0).astype(np.int32)

    on_vehicle = (
        (pts[:, 0] < 3) & (pts[:, 0] > -2) & (np.abs(pts[:, 1]) < 1.5)
    )
    usable = (
        (rng_xy >= MIN_RANGE)
        & (rng_xy <= MAX_RANGE)
        & (col >= 0)
        & (col < range_img_width)
        & ~on_vehicle
        & ~((pts[:, 2] < -3) & (pts[:, 2] > 1))
    )

    region = np.clip(((rng_xy - MIN_RANGE) / delta_r).astype(np.int32), 0,
                     length - 1)

    # representative point per cell (reference keeps the LAST written)
    cell = row.astype(np.int64) * range_img_width + col
    cloud_index = -np.ones(range_img_height * range_img_width, np.int64)
    u = np.where(usable)[0]
    cloud_index[cell[u]] = u  # later indices overwrite like the loop

    # per-(col, region) min z
    reg_flat = col.astype(np.int64) * length + region
    region_minz = np.full(range_img_width * length, 100.0)
    np.minimum.at(region_minz, reg_flat[u], pts[u, 2])
    region_minz = region_minz.reshape(range_img_width, length)

    # --- RECM fill + smooth (jcp.py:75-106), vectorised across columns
    missing = region_minz == 100.0
    region_minz[:, 0] = np.minimum(region_minz[:, 0], sensor_height + TH_G)
    # leading missing -> default; later missing -> previous (forward fill)
    for j in range(1, length):
        m = missing[:, j]
        had_valid = ~missing[:, :j].all(axis=1)
        region_minz[:, j] = np.where(
            m & ~had_valid, sensor_height + TH_G, region_minz[:, j]
        )
        region_minz[:, j] = np.where(
            m & had_valid, region_minz[:, j - 1], region_minz[:, j]
        )
    # outlier smoothing: |z_i - z_{i-1}| > .5 and |z_i - z_{i+1}| > .5
    mid = region_minz[:, 1:-1]
    jump = (np.abs(mid - region_minz[:, :-2]) > 0.5) & (
        np.abs(mid - region_minz[:, 2:]) > 0.5
    )
    region_minz[:, 1:-1] = np.where(
        jump, 0.5 * (region_minz[:, :-2] + region_minz[:, 2:]), mid
    )
    # slope clamp outward
    slope = delta_r * np.tan(np.deg2rad(SIGMA_DEG))
    pre = np.minimum(region_minz[:, 0], sensor_height)
    for j in range(1, length):
        region_minz[:, j] = np.minimum(region_minz[:, j], pre + slope)
        pre = region_minz[:, j]

    # --- classify cells
    img = np.full((range_img_height, range_img_width), EMPTY, np.int8)
    occupied = cloud_index.reshape(range_img_height, range_img_width) >= 0
    ci = cloud_index.reshape(range_img_height, range_img_width)
    safe_ci = np.maximum(ci, 0)
    cell_col = np.broadcast_to(
        np.arange(range_img_width)[None, :], img.shape
    )
    cell_region = np.zeros_like(img, np.int32)
    cell_region[occupied] = region[safe_ci[occupied]]
    th = region_minz[cell_col, cell_region]
    z = pts[safe_ci, 2]
    img[occupied] = np.where(
        z[occupied] >= th[occupied] + TH_G, OBSTACLE, GROUND
    )

    # --- JCP boundary refinement (dilate obstacle, re-vote boundary cells)
    try:
        import cv2

        kernel = cv2.getStructuringElement(cv2.MORPH_CROSS, (5, 5))
        dil = cv2.dilate((img == OBSTACLE).astype(np.uint8), kernel) > 0
    except Exception:
        from scipy import ndimage

        cross = np.zeros((5, 5), bool)
        cross[2, :] = cross[:, 2] = True
        dil = ndimage.binary_dilation(img == OBSTACLE, cross)
    boundary = dil & (img == GROUND)

    offs = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)
            if not (dy == 0 and dx == 0)]
    pts_img = np.zeros((range_img_height, range_img_width, 3), np.float32)
    pts_img[occupied] = pts[safe_ci[occupied]]
    for _ in range(jcp_iterations):
        if not boundary.any():
            break
        score_obst = np.zeros(img.shape, np.float64)
        score_grnd = np.zeros(img.shape, np.float64)
        for dy, dx in offs:
            nimg = np.full_like(img, EMPTY)
            nocc = np.zeros_like(occupied)
            npts = np.zeros_like(pts_img)
            ys = slice(max(dy, 0), range_img_height + min(dy, 0))
            yd = slice(max(-dy, 0), range_img_height + min(-dy, 0))
            xs = slice(max(dx, 0), range_img_width + min(dx, 0))
            xd = slice(max(-dx, 0), range_img_width + min(-dx, 0))
            nimg[yd, xd] = img[ys, xs]
            nocc[yd, xd] = occupied[ys, xs]
            npts[yd, xd] = pts_img[ys, xs]
            d3 = np.linalg.norm(pts_img - npts, axis=-1)
            w = np.where(nocc & (d3 <= 3.0), np.exp(-5.0 * d3), 0.0)
            score_obst += np.where(nimg == OBSTACLE, w, 0.0)
            score_grnd += np.where(nimg == GROUND, w, 0.0)
        new_label = np.where(score_obst > score_grnd, OBSTACLE, GROUND)
        img = np.where(boundary, new_label, img)

    is_ground_img = img == GROUND
    return is_ground_img[row, np.clip(col, 0, range_img_width - 1)]
