"""Point-cloud -> BEV image helpers for TB logging (host-side numpy).

Behavioral reference: liso/visu/pcl_image.py:7-157 and liso/visu/utils.py:9-47.
These feed image summaries only, so they run in numpy on the host (the
device-side pillarization lives in models/pillar_encoder.py). Deltas:

  * create_topdown_f32_pcl_image_variable_extent uses a true per-pixel max
    reduce (np.maximum.at) — the reference's torch scatter_ keeps an
    arbitrary colliding point (its scatter_reduce(amax) intent is commented
    out at pcl_image.py:96-103); max is deterministic and is what the visu
    wants (brightest return wins).
  * apply_cmap / plot_to_np_image gate matplotlib behind a lazy import so
    headless test environments without a display still import this module.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def pillarize_pointcloud(
    pcl: np.ndarray, bev_range_m: np.ndarray, pillar_bev_resolution: np.ndarray
) -> np.ndarray:
    """[N, >=2] points -> integer [N, 2] (row, col) pillar coords, clipped
    to the grid (reference pcl_image.py:7-20: xy shifted by half range,
    normalized, scaled to resolution)."""
    assert pcl.ndim == 2, pcl.shape
    bev_range_m = np.asarray(bev_range_m, np.float32)
    res = np.asarray(pillar_bev_resolution, np.int32)
    coords = (pcl[:, :2] + 0.5 * bev_range_m) / bev_range_m
    coords = (coords * res.astype(np.float32)).astype(np.int32)
    return np.clip(coords, 0, res - 1)


def create_occupancy_pcl_image(
    pcl: np.ndarray, bev_range_m: np.ndarray, img_shape: np.ndarray
) -> np.ndarray:
    """[N, >=2] -> float [H, W, 1] occupancy (reference pcl_image.py:46-57)."""
    img = np.zeros(tuple(np.asarray(img_shape, int)) + (1,), np.float32)
    rc = pillarize_pointcloud(pcl, bev_range_m, img_shape)
    img[rc[:, 0], rc[:, 1]] = 1.0
    return img


def project_2d_pcl_to_rowcol_nonsquare_bev_range(
    pcl_2d: np.ndarray,
    coords_min: np.ndarray,
    coords_max: np.ndarray,
    img_grid_size: np.ndarray,
) -> np.ndarray:
    """Float (row, col) image coords for a possibly non-square extent; an
    ISOTROPIC scale (min of the two axes' factors) preserves aspect ratio
    exactly like the reference (pcl_image.py:140-157)."""
    coords_min = np.asarray(coords_min, np.float32)
    coords_max = np.asarray(coords_max, np.float32)
    grid = np.asarray(img_grid_size, np.float32)
    factors = grid / (coords_max - coords_min)
    f = factors.min()
    return (pcl_2d - coords_min) * f


def get_linear_bev_idx(
    pcl: np.ndarray,
    coords_min: np.ndarray,
    coords_max: np.ndarray,
    img_grid_size: np.ndarray,
    epsilon_m: float = 0.01,
) -> Tuple[np.ndarray, np.ndarray]:
    """(inside_mask [N], linear row-major pixel index [N]) — reference
    pcl_image.py:114-137 (1 cm epsilon shrink on the extent)."""
    coords_min = np.asarray(coords_min, np.float32)
    coords_max = np.asarray(coords_max, np.float32)
    grid = np.asarray(img_grid_size, np.int64)
    xy = pcl[:, :2]
    inside = np.all(xy > coords_min + epsilon_m, -1) & np.all(
        xy < coords_max - epsilon_m, -1
    )
    rowcol = project_2d_pcl_to_rowcol_nonsquare_bev_range(
        xy, coords_min, coords_max, grid
    ).astype(np.int64)
    rowcol = np.clip(rowcol, 0, grid - 1)  # isotropic scale can overshoot
    return inside, rowcol[:, 0] * grid[1] + rowcol[:, 1]


def create_topdown_f32_pcl_image_variable_extent(
    pcl: np.ndarray,
    intensity: np.ndarray,
    coords_min: np.ndarray,
    coords_max: np.ndarray,
    img_grid_size: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """(intensity image [H, W], occupancy [H, W] bool) — reference
    pcl_image.py:59-111 with a deterministic max reduce per pixel.
    Intensity is min-max normalized to [0, 1] when outside that range."""
    assert pcl.ndim == 2 and pcl.shape[-1] == 4, pcl.shape
    intensity = np.asarray(intensity, np.float32)
    assert intensity.shape == (pcl.shape[0],), intensity.shape
    if intensity.size and (intensity.min() < 0.0 or intensity.max() > 1.0):
        intensity = intensity - intensity.min()
        ptp = intensity.max()
        intensity = intensity / ptp if ptp > 0 else intensity
    grid = np.asarray(img_grid_size, np.int64)
    inside, lin = get_linear_bev_idx(pcl, coords_min, coords_max, grid)
    lin = lin[inside]
    vals = intensity[inside]
    img = np.zeros(int(grid[0] * grid[1]), np.float32)
    np.maximum.at(img, lin, vals)
    occ = np.zeros(int(grid[0] * grid[1]), bool)
    occ[lin] = True
    return img.reshape(tuple(grid)), occ.reshape(tuple(grid))


# ---------------------------------------------------------------------------
# utils.py equivalents
# ---------------------------------------------------------------------------
def limit_visu_image_batches(img: np.ndarray, max_batches: int = 8) -> np.ndarray:
    """Cap the batch dim of TB image grids (reference utils.py:9-14)."""
    return img[:max_batches] if img.shape[0] > max_batches else img


def apply_cmap(
    x: np.ndarray, normalize: bool = True, input_has_channel_dim: bool = False
) -> np.ndarray:
    """Magma colormap over a scalar field -> RGBA floats (utils.py:16-28)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    from matplotlib import cm

    x = np.asarray(x, np.float32)
    if input_has_channel_dim:
        assert x.shape[-1] == 1, x.shape
        x = x[..., 0]
    if normalize:
        ptp = np.ptp(x)
        x = (x - x.min()) / ptp if ptp > 0 else np.zeros_like(x)
    return cm.get_cmap("magma")(x)


def plot_to_np_image(figure) -> np.ndarray:
    """Rasterize a matplotlib figure to an RGB uint8 array and close it
    (utils.py:30-47, without the PIL round trip)."""
    import matplotlib.pyplot as plt

    figure.canvas.draw()
    w, h = figure.canvas.get_width_height()
    buf = np.frombuffer(figure.canvas.buffer_rgba(), np.uint8)
    img = buf.reshape(h, w, 4)[..., :3].copy()
    plt.close(figure)
    return img
