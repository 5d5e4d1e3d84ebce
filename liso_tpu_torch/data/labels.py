"""Class label maps (reference: liso/datasets/labelmap/__init__.py:46-196 +
the KITTI class collapsing of torch_dataset_commons.py:43-71)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

KITTI_MOVABLE_CLASSES = ("Car", "Pedestrian", "Cyclist")

KITTI_MAP_TO_SIMPLE_CLASSES = {
    "Car": "Car",
    "PassengerCar": "Car",
    "Pedestrian": "Pedestrian",
    "Person": "Pedestrian",
    "Van": "Car",
    "Truck": "Car",
    "Person_sitting": "Pedestrian",
    "Cyclist": "Cyclist",
    "Tram": "Car",
}

KITTI_IGNORE_NON_MOVABLE_CLASSMAPPING = {
    "Unknown": None,
    "DontCare": None,
    "Car": "movable",
    "PassengerCar": "movable",
    "Pedestrian": "movable",
    "Person": "movable",
    "Van": "movable",
    "Truck": "movable",
    "Person_sitting": None,
    "Cyclist": "movable",
    "Tram": "movable",
    "Misc": None,
    "LargeVehicle": "movable",
}

NUSCENES_MOVABLE = {
    # detection-name aliases (devkit collapsed names)
    "car": "movable",
    "truck": "movable",
    "bus": "movable",
    "trailer": "movable",
    "construction_vehicle": "movable",
    "pedestrian": "movable",
    "motorcycle": "movable",
    "bicycle": "movable",
    "traffic_cone": None,
    "barrier": None,
    # raw nuScenes category names (label_mappings.yml
    # nuscenes2static_dynamic_ground "dynamic" list; movable_object.* are
    # dynamic-capable for flow but NOT evaluated as movable detections)
    "vehicle.car": "movable",
    "vehicle.truck": "movable",
    "vehicle.bus.bendy": "movable",
    "vehicle.bus.rigid": "movable",
    "vehicle.trailer": "movable",
    "vehicle.construction": "movable",
    "vehicle.emergency.ambulance": "movable",
    "vehicle.emergency.police": "movable",
    "vehicle.motorcycle": "movable",
    "vehicle.bicycle": "movable",
    "human.pedestrian.adult": "movable",
    "human.pedestrian.child": "movable",
    "human.pedestrian.construction_worker": "movable",
    "human.pedestrian.personal_mobility": "movable",
    "human.pedestrian.police_officer": "movable",
    "human.pedestrian.stroller": "movable",
    "human.pedestrian.wheelchair": "movable",
    "animal": "movable",
    "movable_object.barrier": None,
    "movable_object.debris": None,
    "movable_object.pushable_pullable": None,
    "movable_object.trafficcone": None,
    "static_object.bicycle_rack": None,
}

# nuScenes raw category -> official detection name (devkit
# category_to_detection_name; used for the per-class NUSC_OFFICIAL bank)
NUSCENES_CATEGORY_TO_DETECTION_NAME = {
    "vehicle.car": "car",
    "vehicle.truck": "truck",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.trailer": "trailer",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
}

# Waymo / AV2 movable maps (reference label_mappings.yml aggregations)
WAYMO_MOVABLE = {
    "TYPE_VEHICLE": "movable",
    "TYPE_PEDESTRIAN": "movable",
    "TYPE_CYCLIST": "movable",
    "TYPE_SIGN": None,
    "TYPE_UNKNOWN": None,
    "VEHICLE": "movable",
    "PEDESTRIAN": "movable",
    "CYCLIST": "movable",
    # OpenPCDet label spelling (waymo_processed_data annos["name"])
    "Vehicle": "movable",
    "Pedestrian": "movable",
    "Cyclist": "movable",
    "Sign": None,
}

AV2_MOVABLE = {
    name: "movable"
    for name in (
        "REGULAR_VEHICLE", "PEDESTRIAN", "BICYCLIST", "MOTORCYCLIST",
        "WHEELED_RIDER", "BOLLARD", "LARGE_VEHICLE", "BUS", "BOX_TRUCK",
        "TRUCK", "VEHICULAR_TRAILER", "TRUCK_CAB", "SCHOOL_BUS",
        "ARTICULATED_BUS", "MOTORCYCLE", "BICYCLE", "WHEELED_DEVICE",
        "WHEELCHAIR", "STROLLER", "DOG",
    )
}
AV2_MOVABLE.update({
    "BOLLARD": None, "CONSTRUCTION_CONE": None, "SIGN": None,
    "CONSTRUCTION_BARREL": None, "STOP_SIGN": None,
    "MOBILE_PEDESTRIAN_CROSSING_SIGN": None, "MESSAGE_BOARD_TRAILER": None,
    "TRAFFIC_LIGHT_TRAILER": None,
})


class LabelMap:
    """name -> contiguous class idx, with unmapped names -> -1 (ignore)."""

    def __init__(self, mapping: Dict[str, Optional[str]]):
        self.mapping = mapping
        targets = sorted({v for v in mapping.values() if v is not None})
        self.class_names = tuple(targets)
        self.name_to_idx = {n: i for i, n in enumerate(targets)}

    def idxs_from_names(self, names: Sequence[str]) -> np.ndarray:
        out = np.full(len(names), -1, np.int32)
        for i, n in enumerate(names):
            tgt = self.mapping.get(str(n))
            if tgt is not None:
                out[i] = self.name_to_idx[tgt]
        return out


KITTI_MOVABLE_MAP = LabelMap(KITTI_IGNORE_NON_MOVABLE_CLASSMAPPING)
NUSCENES_MOVABLE_MAP = LabelMap(NUSCENES_MOVABLE)
WAYMO_MOVABLE_MAP = LabelMap(WAYMO_MOVABLE)
AV2_MOVABLE_MAP = LabelMap(AV2_MOVABLE)


# ---------------------------------------------------------------------------
# Raw-index label maps (reference liso/datasets/labelmap/__init__.py:46-196
# over liso/config/label_mappings.yml): per-dataset raw semantic-index
# tables, merged-class aggregations (e.g. static/dynamic/ground for the
# SLIM artificial labels), and per-class colors.
# ---------------------------------------------------------------------------
class RawLabelMap:
    """ridx (raw per-point label index) <-> rname <-> mname (merged class)
    <-> midx, plus an RGBA color per raw index."""

    def __init__(self, ridx_rname: Dict[int, str],
                 mname_rnames: Optional[Dict[str, Sequence[str]]] = None,
                 colors: Optional[Dict] = None):
        self.ridx_rname = {int(k): str(v) for k, v in ridx_rname.items()}
        assert len(set(self.ridx_rname.values())) == len(self.ridx_rname)
        self.rname_ridx = {v: k for k, v in self.ridx_rname.items()}
        mname_rnames = dict(mname_rnames or {"ignore": []})
        mname_rnames.setdefault("ignore", [])
        # raw names not covered by any merged class map to themselves
        covered = {r for rs in mname_rnames.values() for r in rs}
        for rn in sorted(self.ridx_rname.values()):
            if rn not in covered:
                mname_rnames[rn] = [rn]
        self.mname_rnames = mname_rnames
        self.mnames = sorted(mname_rnames)
        self.mname_midx = {m: i for i, m in enumerate(self.mnames)}
        self.ridx_midx = {
            self.rname_ridx[rn]: self.mname_midx[m]
            for m, rns in mname_rnames.items()
            for rn in rns
            if rn in self.rname_ridx
        }
        # colors keyed by raw idx or raw name; default = evenly spaced hue
        self.ridx_color: Dict[int, tuple] = {}
        if colors:
            for k, c in colors.items():
                ridx = (
                    int(k) if not isinstance(k, str) or k.isdigit()
                    else self.rname_ridx.get(k)
                )
                if ridx is not None and ridx in self.ridx_rname:
                    self.ridx_color[ridx] = tuple(
                        float(x) / 255.0 for x in c
                    )
        for i, ridx in enumerate(sorted(self.ridx_rname)):
            if ridx not in self.ridx_color:
                t = i / max(len(self.ridx_rname) - 1, 1)
                self.ridx_color[ridx] = (t, 1.0 - abs(2 * t - 1), 1.0 - t, 1.0)

    def midx_of(self, raw_idx: np.ndarray) -> np.ndarray:
        """[N] raw indices -> merged class indices (-1 for unknown raws)."""
        lut = np.full(max(self.ridx_rname) + 1, -1, np.int32)
        for r, m in self.ridx_midx.items():
            lut[r] = m
        raw = np.asarray(raw_idx, np.int64)
        out = np.full(raw.shape, -1, np.int32)
        ok = (raw >= 0) & (raw < len(lut))
        out[ok] = lut[raw[ok]]
        return out

    def mnames_of(self, raw_idx: np.ndarray):
        return [
            self.mnames[m] if m >= 0 else "ignore"
            for m in self.midx_of(raw_idx)
        ]

    def colors_of(self, raw_idx: np.ndarray) -> np.ndarray:
        """[N] raw indices -> [N, 4] RGBA floats (unknown/negative raws get
        the zero 'unknown' row, not class 0's color)."""
        arr = np.zeros((max(self.ridx_rname) + 2, 4), np.float32)
        for r, c in self.ridx_color.items():
            arr[r] = c
        raw = np.asarray(raw_idx, np.int64)
        unknown = len(arr) - 1
        raw = np.where((raw < 0) | (raw >= unknown), unknown, raw)
        return arr[raw]


def get_label_map_from_file(raw_map_name: str,
                            aggregation_name: Optional[str] = None,
                            color_map_name: Optional[str] = None,
                            path=None) -> RawLabelMap:
    """labelmap/__init__.get_label_map_from_file over
    liso_tpu_torch/config/label_mappings.yml."""
    from pathlib import Path

    import yaml

    p = Path(path) if path else (
        Path(__file__).parent.parent / "config" / "label_mappings.yml"
    )
    cfg = yaml.safe_load(open(p))
    return RawLabelMap(
        cfg["label_names"][raw_map_name],
        cfg["label_aggregation"].get(aggregation_name),
        cfg["label_colors"].get(color_map_name),
    )
