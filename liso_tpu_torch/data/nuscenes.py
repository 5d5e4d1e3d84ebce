"""nuScenes dataset and its ETL entry `create_nuscenes` (port of
liso_tpu/data/nuscenes.py).

Behavioral reference: liso/datasets/nuscenes_torch_dataset.py (690 LoC) +
liso/datasets/nuscenes/create.py (686 LoC). The converted per-sample npy
format is the shared one (pcl_t0/t1/t2, is_ground_*, odom_*, kiss_odom_*,
objects_t0, name "scene-XXXX_<sample_token>"); samples are 10 Hz sweeps,
so mining extrapolates motion x5 to the 2 Hz keyframes
(liso/tracker/tracking.py:338-348 — here: time_delta_s=0.1 with velocity
scaling handled by MiningCfg.time_between_frames_s).

The ETL is devkit-free (data/create_nuscenes.py parses the JSON
tables directly, like the AV2 ETL's pyarrow approach); the dataset class
reads both the reference `objects` list format and the grouped
objects_{tk} format.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from liso_tpu_torch.data.dataset import DataCfg, LidarDataset
from liso_tpu_torch.data.kitti import _boxes_from_objects
from liso_tpu_torch.data.labels import NUSCENES_MOVABLE_MAP


class NuscenesDataset(LidarDataset):
    SUBDIR = "nuscenes"

    def __init__(self, cfg: DataCfg, root: Path, mode: str = "train", **kw):
        root = Path(root)
        files = []
        for d in (root / self.SUBDIR / mode, root / mode,
                  root / self.SUBDIR, root):
            if d.exists():
                files = sorted(d.glob("*.npy"))
                if files:
                    break
        if not files:
            raise FileNotFoundError(f"no nuscenes samples under {root}")
        super().__init__(cfg, files, **kw)
        self._seqs = {}
        for i, f in enumerate(files):
            scene = f.stem.split("_")[0]
            self._seqs.setdefault(scene, []).append(i)
        self._seq_keys = sorted(self._seqs)

    @property
    def num_sequences(self):
        return len(self._seq_keys)

    def get_consecutive_sample_idxs_for_sequence(self, seq_of_idx: int):
        return self._seqs[self._seq_keys[seq_of_idx % len(self._seq_keys)]]

    def extract_gt_boxes(self, content: dict, time_key: str):
        gt = content.get("gt", content)
        # reference ETL format (create.py:442): one `objects` list of dicts
        # with interpolated pose_t0/t1/t2 (10 Hz between 2 Hz keyframes —
        # the keyframe-interpolation handling of nuscenes_torch_dataset)
        objects = gt.get("objects")
        if objects is not None:
            objs = list(np.asarray(objects, dtype=object))
            objs = [o for o in objs if f"pose_{time_key}" in o]
            if not objs:
                return None
            grouped = {
                "poses": np.stack(
                    [np.asarray(o[f"pose_{time_key}"]) for o in objs]
                ),
                "size": np.stack([np.asarray(o["size"]) for o in objs]),
                "category": np.asarray([o["category"] for o in objs]),
            }
            boxes = _boxes_from_objects(grouped, NUSCENES_MOVABLE_MAP)
            if boxes is None:
                return None
            # speed from the devkit-style box_velocity (global frame; the
            # norm is frame-independent) for the moving/still AP split
            velo = []
            cid = NUSCENES_MOVABLE_MAP.idxs_from_names(
                [str(o["category"]) for o in objs]
            )
            for o, c in zip(objs, cid):
                if c < 0:
                    continue
                v = np.asarray(
                    o.get("box_velocity", np.full(3, np.nan)), np.float64
                )
                velo.append(
                    0.0 if not np.isfinite(v).all()
                    else float(np.linalg.norm(v[:2]))
                )
            boxes["velo"] = np.asarray(velo, np.float32)[:, None]
            return boxes
        objects = gt.get(f"objects_{time_key}")
        if objects is None:
            return None
        return _boxes_from_objects(objects, NUSCENES_MOVABLE_MAP)


def create_nuscenes(nusc_root, target_dir, version="v1.0-trainval",
                    splits=None, use_icp=False):
    """Devkit-free ETL entry (reference datasets/nuscenes/create.py) —
    parses the JSON tables directly; see liso_tpu_torch.data.create_nuscenes."""
    from liso_tpu_torch.data.create_nuscenes import main as _main

    argv = ["--nusc_root", str(nusc_root), "--target_dir", str(target_dir),
            "--version", version]
    if splits:
        argv += ["--splits", str(splits)]
    if use_icp:
        argv += ["--use_icp"]
    _main(argv)
