"""Augmentation-DB visualizer.

Behavioral reference: liso/visu/visualize_box_augmentation_database.py:1-186
— render each box-points snippet (in box coordinates) as a top-down image
with the box rectangle overlaid, tile them into grids, and log to
TensorBoard. The torchvision make_grid is replaced by plain numpy tiling.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from liso_tpu_torch.visu.bbox_image import _draw_line


def render_box_snippet(
    pcl_box_cosy: np.ndarray,
    dims_lwh: np.ndarray,
    img_px: int = 96,
    extent_m: float = 6.0,
) -> np.ndarray:
    """One augm-DB entry -> [img_px, img_px, 3] u8 top-down image: points
    colored by height, box rectangle in green (reference
    create_single_box_images_with_points)."""
    img = np.zeros((img_px, img_px, 3), np.uint8)
    if len(pcl_box_cosy):
        xy = pcl_box_cosy[:, :2]
        rc = ((xy / extent_m + 0.5) * img_px).astype(int)
        ok = (rc >= 0).all(-1) & (rc < img_px).all(-1)
        z = pcl_box_cosy[ok, 2] if pcl_box_cosy.shape[1] > 2 else None
        rc = rc[ok]
        if len(rc):
            if z is not None and len(z):
                zn = np.clip(
                    (z - z.min()) / max(float(np.ptp(z)), 1e-6), 0.0, 1.0
                )
                img[rc[:, 0], rc[:, 1], 0] = (55 + 200 * zn).astype(np.uint8)
                img[rc[:, 0], rc[:, 1], 2] = (255 - 200 * zn).astype(
                    np.uint8
                )
            else:
                img[rc[:, 0], rc[:, 1]] = 220
    l, w = float(dims_lwh[0]), float(dims_lwh[1])
    corners = np.array(
        [[l / 2, w / 2], [l / 2, -w / 2], [-l / 2, -w / 2], [-l / 2, w / 2]]
    )
    px = ((corners / extent_m + 0.5) * img_px).astype(int)
    for i in range(4):
        _draw_line(img, px[i], px[(i + 1) % 4], (0, 255, 0))
    return img


def grid_of_snippets(
    augm_db: Dict[str, list],
    num_boxes: int = 32,
    per_row: int = 8,
    img_px: int = 96,
    rng: Optional[np.random.RandomState] = None,
) -> List[np.ndarray]:
    """Sample entries, tile into [rows*img_px, per_row*img_px, 3] grids
    (one grid per num_boxes/per_row^2 chunk, like make_grid pages)."""
    n = len(augm_db["pcl_in_box_cosy"])
    if n == 0:
        return []
    rng = rng or np.random.RandomState(0)
    idxs = rng.choice(n, size=min(num_boxes, n), replace=False)
    tiles = []
    for i in idxs:
        dims = np.asarray(augm_db["boxes"][i]["dims"]).reshape(-1)
        tiles.append(
            render_box_snippet(
                np.asarray(augm_db["pcl_in_box_cosy"][i]), dims, img_px
            )
        )
    pages = []
    per_page = per_row * per_row
    for p0 in range(0, len(tiles), per_page):
        chunk = tiles[p0 : p0 + per_page]
        rows = []
        for r0 in range(0, len(chunk), per_row):
            row = chunk[r0 : r0 + per_row]
            while len(row) < per_row:
                row.append(np.zeros_like(tiles[0]))
            rows.append(np.concatenate(row, axis=1))
        pages.append(np.concatenate(rows, axis=0))
    return pages


def log_augm_db_visualization(
    augm_db: Dict[str, list],
    writer,
    global_step: int,
    writer_prefix: str = "augm_db/",
    num_boxes: int = 32,
):
    """visualize_augm_boxes_with_points_inside_them: render + TB log."""
    for i, page in enumerate(
        grid_of_snippets(augm_db, num_boxes=num_boxes)
    ):
        writer.add_image(
            f"{writer_prefix}snippets_{i}", page, global_step,
            dataformats="HWC",
        )


def main(argv=None):
    """Standalone visualizer (reference
    visu/visualize_box_augmentation_database.py run as a script): render
    snippet grids from an augm-DB .npy to PNG pages.

      python -m liso_tpu_torch.visu.augm_db_image DB.npy [--out DIR] [--num 32]
    """
    import argparse
    from pathlib import Path

    p = argparse.ArgumentParser()
    p.add_argument("db", help="augm_db .npy (tracker/dbs.save_augm_db)")
    p.add_argument("--out", default=".")
    p.add_argument("--num", type=int, default=32)
    args = p.parse_args(argv)

    from PIL import Image

    from liso_tpu_torch.tracker.dbs import load_augm_db

    db = load_augm_db(args.db)
    # on-disk DBs are finalized (stacked box arrays); the renderer takes
    # the raw per-entry form
    db = dict(db)
    db["boxes"] = [
        {k: v[i] for k, v in db["boxes"].items()}
        for i in range(len(db["pcl_in_box_cosy"]))
    ]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, page in enumerate(grid_of_snippets(db, num_boxes=args.num)):
        path = out / f"augm_db_snippets_{i}.png"
        Image.fromarray(
            (np.clip(page, 0, 1) * 255).astype(np.uint8)
        ).save(path)
        paths.append(path)
    print(f"wrote {len(paths)} page(s) to {out}")
    return paths


if __name__ == "__main__":
    main()
