"""KITTI dataset subclasses (raw / tracking / object); port of
liso_tpu/data/kitti.py.

Behavioral reference: liso/datasets/{kitti_raw_torch_dataset.py:24-452,
kitti_tracking_torch_dataset.py, kitti_object_torch_dataset.py:238-242}.
All three consume the per-sample npy dicts written by the ETL scripts
(liso_tpu/data/create_kitti.py / reference datasets/kitti/create_*.py — the
formats are identical):

  * raw:      pcl_t0/t1/t2, is_ground_*, odom_t0_t1/t0_t2, kiss_odom_*,
              name "date_drive_frameidx" (no labels -> training split);
  * tracking: like raw + objects_{tk} GT boxes (flow eval / val);
  * object:   pcl_t0 (+pcl_t1 from matched raw) + objects_t0 + ignore
              regions (detection eval).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from liso_tpu_torch.data.dataset import DataCfg, LidarDataset
from liso_tpu_torch.data.labels import KITTI_MOVABLE_MAP


def _boxes_from_objects(objects: dict, label_map=KITTI_MOVABLE_MAP):
    """objects_{tk} = {poses [K,4,4], size [K,3], category [K]} ->
    box attr dict (torch_dataset_commons.kitti_extract_boxes_for_timestamp).
    """
    poses = np.asarray(objects["poses"], np.float64)
    if poses.ndim == 2:
        poses = poses[None]
    k = len(poses)
    if k == 0:
        return None
    pos = poses[:, :3, 3].astype(np.float32)
    rot = np.arctan2(poses[:, 1, 0], poses[:, 0, 0]).astype(np.float32)[:, None]
    dims = np.asarray(objects["size"], np.float32).reshape(k, 3)
    class_id = label_map.idxs_from_names(
        [str(c) for c in np.asarray(objects["category"]).reshape(-1)]
    )[:, None]
    keep = class_id[:, 0] >= 0
    return {
        "pos": pos[keep],
        "dims": dims[keep],
        "rot": rot[keep],
        "probs": np.ones((keep.sum(), 1), np.float32),
        "velo": np.zeros((keep.sum(), 1), np.float32),
        "class_id": class_id[keep].astype(np.float32),
    }


class KittiRawDataset(LidarDataset):
    """Training split: no labels (kitti_raw_torch_dataset.py:24)."""

    SUBDIR = "kitti_raw"

    def __init__(self, cfg: DataCfg, root: Path, **kw):
        root = Path(root)
        d = root / self.SUBDIR if (root / self.SUBDIR).exists() else root
        files = sorted(d.glob("*.npy"))
        if not files:
            raise FileNotFoundError(f"no {self.SUBDIR} samples under {root}")
        super().__init__(cfg, files, **kw)
        # sequences keyed by date_drive prefix
        self._seqs = {}
        for i, f in enumerate(files):
            key = "_".join(f.stem.split("_")[:-1])
            self._seqs.setdefault(key, []).append(i)
        self._seq_keys = sorted(self._seqs)

    @property
    def num_sequences(self):
        return len(self._seq_keys)

    def get_consecutive_sample_idxs_for_sequence(self, seq_of_idx: int):
        return self._seqs[self._seq_keys[seq_of_idx % len(self._seq_keys)]]


class KittiTrackingDataset(KittiRawDataset):
    """Val split with GT boxes + GT object flow
    (kitti_tracking_torch_dataset.py; samples written by
    liso_tpu/data/create_kitti_tracking.py)."""

    SUBDIR = "kitti_tracking"

    def extract_gt_boxes(self, content: dict, time_key: str):
        gt = content.get("gt", content)
        objects = gt.get(f"objects_{time_key}")
        if objects is None:
            return None
        boxes = _boxes_from_objects(objects)
        if boxes is None:
            return None
        # per-box speed from track motion between t0 and t1 (needed for the
        # moving/still AP split; reference derives it from box poses)
        nxt = gt.get("objects_t1" if time_key == "t0" else "objects_t2")
        if (
            nxt is not None
            and "track_ids" in objects
            and "track_ids" in nxt
            and len(boxes["pos"])
        ):
            ids_a = np.asarray(objects["track_ids"]).reshape(-1)
            poses_a = np.asarray(objects["poses"], np.float64).reshape(
                -1, 4, 4
            )
            keep_mask = KITTI_MOVABLE_MAP.idxs_from_names(
                [str(c) for c in np.asarray(objects["category"]).reshape(-1)]
            ) >= 0
            ids_a, poses_a = ids_a[keep_mask], poses_a[keep_mask]
            ids_b = list(np.asarray(nxt["track_ids"]).reshape(-1))
            poses_b = np.asarray(nxt["poses"], np.float64).reshape(-1, 4, 4)
            ab = "t0_t1" if time_key == "t0" else "t1_t2"
            odom = content.get(f"odom_{ab}")
            odom = (
                np.asarray(odom, np.float64) if odom is not None else np.eye(4)
            )
            dt = self.cfg.time_delta_s
            velo = np.zeros((len(ids_a), 1), np.float32)
            for i, tid in enumerate(ids_a):
                if tid in ids_b:
                    # object displacement net of ego motion
                    pb_in_a = odom @ poses_b[ids_b.index(tid)]
                    velo[i, 0] = (
                        np.linalg.norm(pb_in_a[:2, 3] - poses_a[i][:2, 3]) / dt
                    )
            boxes["velo"] = velo
        return boxes


class KittiObjectDataset(KittiTrackingDataset):
    """Detection eval split (kitti_object_torch_dataset.py); samples carry
    only (t0, t1) so skip frames are disabled. Reads the
    kitti_object_w_future_pcl/{train,val,test} layout written by
    liso_tpu/data/create_kitti_object.py (split selected via `split`)."""

    SUBDIR = "kitti_object_w_future_pcl"

    def __init__(self, cfg: DataCfg, root: Path, split: str = "val", **kw):
        root = Path(root)
        candidates = [
            root / self.SUBDIR / split,
            root / self.SUBDIR,
            root / "kitti_object",  # round-1 layout
            root,
        ]
        for d in candidates:
            files = sorted(d.glob("*.npy")) if d.exists() else []
            if files:
                break
        if not files:
            raise FileNotFoundError(
                f"no kitti object samples under {root} (split {split})"
            )
        LidarDataset.__init__(
            self, cfg._replace(use_skip_frames="never"), files, **kw
        )
        self._seqs = {0: list(range(len(files)))}
        self._seq_keys = [0]

    def select_time_keys(self, rng=None):
        return "t0", "t1", self.cfg.time_delta_s

    def _odom(self, content: dict, a: str, b: str) -> np.ndarray:
        """Object samples have no odometry (eval-only, reference
        kitti_object dataset) — identity keeps the pipeline total."""
        try:
            return super()._odom(content, a, b)
        except KeyError:
            return np.eye(4)

    def _build(self, content, idx, a, b, dt):
        # samples without a matched raw t1 frame: duplicate t0 (static pair)
        if "pcl_t1" not in content:
            content = dict(content)
            content["pcl_t1"] = content["pcl_t0"]
            if "is_ground_t0" in content:
                content["is_ground_t1"] = content["is_ground_t0"]
        return super()._build(content, idx, a, b, dt)
