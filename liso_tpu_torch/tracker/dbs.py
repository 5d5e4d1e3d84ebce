"""Mined-box DB and copy-paste augmentation DB (formats match the
reference so downstream tooling can read either framework's exports).

Behavioral reference: liso/tracker/mined_box_db_utils.py:6-21,
liso/tracker/augm_box_db_utils.py:13-183, liso/tracker/tracking.py:1927-1962.

  * mined DB: {sample_id: {"lidar_T_box": [K,4,4] f64, "raw_box": dict of
    box-attr arrays, "track_id": [K]}} saved with np.savez_compressed (the
    dict is pickled as arr_0, like the reference).
  * augm DB: {"pcl_in_box_cosy": [arr...], "lidar_rows": [arr...],
    "boxes": dict of stacked attrs, "box_T_sensor": [B,4,4],
    "unique_track_id": [B]} saved with np.save (pickle).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

MIN_PTS_PER_AUGM_BOX = 10


# ---------------------------------------------------------------------------
# mined boxes
# ---------------------------------------------------------------------------
def save_mined_boxes_db(db: Dict[str, dict], path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path.with_suffix(""), db)
    return path.with_suffix(".npz")


def load_mined_boxes_db(path) -> Dict[str, dict]:
    path = Path(path)
    if path.suffix == ".npy":
        return np.load(path, allow_pickle=True).item()
    return np.load(path, allow_pickle=True)["arr_0"].item()


# ---------------------------------------------------------------------------
# augmentation snippets
# ---------------------------------------------------------------------------
def empty_augm_db() -> Dict[str, list]:
    return {
        "pcl_in_box_cosy": [],
        "lidar_rows": [],
        "boxes": [],
        "box_T_sensor": [],
        "unique_track_id": [],
    }


def augm_db_size_mb(db: Dict[str, list]) -> float:
    return sum(v.nbytes for v in db["pcl_in_box_cosy"]) * 1e-6


def shrink_augm_db(db: Dict[str, list], max_size_mb: float) -> Dict[str, list]:
    """Drop lowest-confidence boxes until under the size cap
    (augm_box_db_utils.drop_boxes_from_augmentation_db)."""
    size = augm_db_size_mb(db)
    if size <= max_size_mb or not db["boxes"]:
        return db
    conf = np.array([float(b["probs"].reshape(-1)[0]) for b in db["boxes"]])
    n_keep = int(len(conf) * max_size_mb / size)
    if len(np.unique(conf)) <= 1:
        keep = np.random.choice(len(conf), max(n_keep, 1), replace=False)
    else:
        keep = np.argsort(-conf)[: max(n_keep, 1)]
    return {k: [v[i] for i in keep] for k, v in db.items()}


def finalize_augm_db(db: Dict[str, list]) -> Dict[str, object]:
    """Stack the per-snippet box dicts into the array-of-attrs layout the
    loader expects."""
    if not db["boxes"]:
        return {
            "pcl_in_box_cosy": [],
            "lidar_rows": [],
            "boxes": {
                "pos": np.zeros((0, 3), np.float32),
                "dims": np.zeros((0, 3), np.float32),
                "rot": np.zeros((0, 1), np.float32),
                "probs": np.zeros((0, 1), np.float32),
                "velo": np.zeros((0, 1), np.float32),
            },
            "box_T_sensor": np.zeros((0, 4, 4), np.float64),
            "unique_track_id": np.zeros((0,), np.int64),
        }
    boxes = {
        k: np.stack([b[k] for b in db["boxes"]])
        for k in db["boxes"][0]
    }
    return {
        "pcl_in_box_cosy": db["pcl_in_box_cosy"],
        "lidar_rows": db["lidar_rows"],
        "boxes": boxes,
        "box_T_sensor": np.stack(db["box_T_sensor"]),
        "unique_track_id": np.asarray(db["unique_track_id"], np.int64),
    }


def save_augm_db(db: Dict[str, list], path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path.with_suffix(".npy"), finalize_augm_db(db), allow_pickle=True)
    return path.with_suffix(".npy")


def load_augm_db(
    path, confidence_threshold: float = 0.0
) -> Dict[str, object]:
    """load_sanitize_box_augmentation_database: drop low-confidence and
    almost-empty snippets."""
    db = np.load(path, allow_pickle=True).item()
    n_pts = np.array([len(p) for p in db["pcl_in_box_cosy"]])
    conf = np.squeeze(db["boxes"]["probs"], axis=-1)
    keep = (n_pts > MIN_PTS_PER_AUGM_BOX) & (conf >= confidence_threshold)
    idx = np.where(keep)[0]
    return {
        "pcl_in_box_cosy": [db["pcl_in_box_cosy"][i] for i in idx],
        "lidar_rows": [db["lidar_rows"][i] for i in idx],
        "boxes": {k: v[idx] for k, v in db["boxes"].items()},
        "box_T_sensor": db["box_T_sensor"][idx],
        "unique_track_id": np.asarray(db["unique_track_id"])[idx],
    }


def merge_finalized_augm_dbs(dbs) -> Dict[str, object]:
    """Merge per-worker finalized augm DBs (sharded mining gather,
    SURVEY §2.9): concat snippet lists / stack arrays, re-offsetting
    unique_track_id so ids from different workers never collide."""
    dbs = [d for d in dbs if len(d["boxes"].get("pos", ()))]
    if not dbs:
        return finalize_augm_db(empty_augm_db())
    out = {
        "pcl_in_box_cosy": [], "lidar_rows": [],
        "boxes": {
            k: np.concatenate([d["boxes"][k] for d in dbs])
            for k in dbs[0]["boxes"]
        },
        "box_T_sensor": np.concatenate([d["box_T_sensor"] for d in dbs]),
    }
    ids, offset = [], 0
    for d in dbs:
        out["pcl_in_box_cosy"].extend(d["pcl_in_box_cosy"])
        out["lidar_rows"].extend(d["lidar_rows"])
        tid = np.asarray(d["unique_track_id"], np.int64)
        ids.append(tid + offset)
        offset += int(tid.max()) + 1 if len(tid) else 0
    out["unique_track_id"] = (
        np.concatenate(ids) if ids else np.zeros((0,), np.int64)
    )
    return out


def build_augm_db_from_groundtruth(
    samples,
    min_num_points_in_box: int = 5,
    max_size_of_db_mb: float = 100.0,
) -> Dict[str, object]:
    """GT-based copy-paste DB (reference
    datasets/create_gt_augm_database.build_augmentation_db_from_actual_groundtruth:38):
    for every GT box with >= min points, store the in-box point snippet in
    box coordinates (+ intensity), lidar rows, the box attrs and
    box_T_sensor. `samples` yields dicts with 'pcl' [N,>=4], 'gt_boxes'
    (flat dict incl. 'valid'), optional 'lidar_rows'. Returns the finalized
    array-layout DB (size-capped like the mined variant)."""
    from liso_tpu_torch.tracker.mining import box_poses  # lazy: avoids cycle

    db = empty_augm_db()
    next_id = 0
    for sample in samples:
        pcl = np.asarray(sample["pcl"])
        rows = np.asarray(
            sample.get("lidar_rows", np.zeros(len(pcl), np.int32))
        )
        g = sample["gt_boxes"]
        valid = np.asarray(g["valid"]).reshape(-1).astype(bool)
        for i in np.flatnonzero(valid):
            one = {
                k: np.asarray(v)[i : i + 1].astype(np.float32)
                for k, v in g.items()
                if k != "valid"
            }
            one.setdefault("probs", np.ones((1, 1), np.float32))
            pose = box_poses(one)[0]
            inv = np.linalg.inv(pose)
            p_box = pcl[:, :3] @ inv[:3, :3].T + inv[:3, 3]
            inside = np.all(np.abs(p_box) <= 0.5 * one["dims"][0], axis=-1)
            if inside.sum() < min_num_points_in_box:
                continue
            snippet = np.concatenate(
                [p_box[inside], pcl[inside][:, -1:]], axis=-1
            ).astype(np.float32)
            db["pcl_in_box_cosy"].append(snippet)
            db["lidar_rows"].append(rows[inside])
            db["boxes"].append({k: v[0] for k, v in one.items()})
            db["box_T_sensor"].append(inv)
            db["unique_track_id"].append(next_id)
            next_id += 1
    db = shrink_augm_db(db, max_size_of_db_mb)
    return finalize_augm_db(db)
