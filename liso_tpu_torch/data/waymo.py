"""Waymo Open Dataset + AV2 dataset classes (port of liso_tpu/data/waymo.py).

Behavioral reference: liso/datasets/waymo_torch_dataset.py (1081 LoC;
consumes OpenPCDet preprocessing, generates KISS-ICP poses + JCP ground
labels lazily) and liso/datasets/argoverse2_torch_dataset.py (424 LoC).
Both read the shared converted npy format here; sequence grouping follows
the reference sample-id conventions (waymo: "<segment>_<frame>",
av2: ".../<log_id>/<ts>"). waymo_downsample_factor keeps every n-th frame
(liso_config.yml:92, the liso preset uses 10).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from liso_tpu_torch.data.dataset import DataCfg, LidarDataset
from liso_tpu_torch.data.kitti import _boxes_from_objects


class WaymoDataset(LidarDataset):
    SUBDIR = "waymo"

    def __init__(self, cfg: DataCfg, root: Path, downsample_factor: int = 5,
                 **kw):
        root = Path(root)
        d = root / self.SUBDIR if (root / self.SUBDIR).exists() else root
        files = sorted(d.glob("*.npy"))
        if not files:
            raise FileNotFoundError(f"no waymo samples under {root}")
        files = files[::downsample_factor]
        super().__init__(cfg, files, **kw)
        self._seqs = {}
        for i, f in enumerate(files):
            seg = f.stem.split("_")[0]
            self._seqs.setdefault(seg, []).append(i)
        self._seq_keys = sorted(self._seqs)

    @property
    def num_sequences(self):
        return len(self._seq_keys)

    def get_consecutive_sample_idxs_for_sequence(self, seq_of_idx: int):
        return self._seqs[self._seq_keys[seq_of_idx % len(self._seq_keys)]]

    def extract_gt_boxes(self, content: dict, time_key: str):
        gt = content.get("gt", content)
        objects = gt.get(f"objects_{time_key}")
        if objects is None:
            return None
        from liso_tpu_torch.data.labels import WAYMO_MOVABLE_MAP

        boxes = _boxes_from_objects(objects, WAYMO_MOVABLE_MAP)
        if boxes is None:
            return None
        # create_waymo carries speed + L1/L2 difficulty per box
        cid = WAYMO_MOVABLE_MAP.idxs_from_names(
            [str(c) for c in np.asarray(objects["category"]).reshape(-1)]
        )
        keep = cid >= 0
        if "velo" in objects:
            boxes["velo"] = np.asarray(
                objects["velo"], np.float32
            ).reshape(-1, 1)[keep]
        if "difficulty" in objects:
            boxes["difficulty"] = np.asarray(
                objects["difficulty"], np.float32
            ).reshape(-1, 1)[keep]
        return boxes


class AV2Dataset(LidarDataset):
    SUBDIR = "av2"

    def __init__(self, cfg: DataCfg, root: Path, **kw):
        root = Path(root)
        d = root / self.SUBDIR if (root / self.SUBDIR).exists() else root
        files = sorted(d.rglob("*.npy"))
        if not files:
            raise FileNotFoundError(f"no av2 samples under {root}")
        super().__init__(cfg, files, **kw)
        self._seqs = {}
        for i, f in enumerate(files):
            # av2 sample ids are ".../<log_id>/<ts>" (tracking.py:330)
            log = f.parent.name
            self._seqs.setdefault(log, []).append(i)
        self._seq_keys = sorted(self._seqs)

    @property
    def num_sequences(self):
        return len(self._seq_keys)

    def get_consecutive_sample_idxs_for_sequence(self, seq_of_idx: int):
        return self._seqs[self._seq_keys[seq_of_idx % len(self._seq_keys)]]

    def extract_gt_boxes(self, content: dict, time_key: str):
        gt = content.get("gt", content)
        objects = gt.get(f"objects_{time_key}")
        if objects is None:
            return None
        from liso_tpu_torch.data.labels import LabelMap

        av2_map = LabelMap(
            {"REGULAR_VEHICLE": "movable", "PEDESTRIAN": "movable",
             "BICYCLIST": "movable", "MOTORCYCLIST": "movable",
             "BUS": "movable", "TRUCK": "movable", "LARGE_VEHICLE": "movable",
             "VEHICULAR_TRAILER": "movable", "BICYCLE": "movable",
             "MOTORCYCLE": "movable"}
        )
        return _boxes_from_objects(objects, av2_map)
