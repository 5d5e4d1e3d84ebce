"""Offline ETL: nuScenes -> per-sample npy dicts, WITHOUT the devkit.

Behavioral reference: liso/datasets/nuscenes/create.py:1-686 +
nuscenes_parser.py + trafo_conversion.py. The reference drives the official
devkit; here the JSON tables (scene / sample / sample_data / ego_pose /
calibrated_sensor / sample_annotation / instance) are parsed directly —
the same devkit-free treatment the AV2 ETL got (create_av2.py reads the
feather files with pyarrow).

Per keyframe sample the output dict matches the reference schema
(create.py:442-470): pcl_t0 (+intensities/rows), pcl_t1 at +2 sweeps
(10 Hz) and pcl_t2 at +4 sweeps of the 20 Hz LIDAR_TOP chain, GT scene
flow for all 6 ordered pairs built from interpolated instance poses
(rigid ego flow outside boxes, per-object box-motion flow inside,
create.py:302-428), track_ids_mask_*, is_ground_* (JCP), odom_* from
interpolated ego poses, kiss_odom_* (native ICP), objects (list of dicts
with pose_t0/t1/t2, size lwh, category, box_velocity), name
"{scene}_{idx:02d}_{token}". Points are converted nusc-vehicle ->
"KITTI lidar" frame (translate [0.95, 0, 1.73], trafo_conversion.py:4-11).

Usage:
  python -m liso_tpu_torch.data.create_nuscenes --nusc_root R --target_dir T \
      [--version v1.0-mini] [--splits splits.json]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from liso_tpu_torch.data.ground import jpc_ground_remove

# trafo_conversion.py: kitti-lidar frame = vehicle frame lifted to the
# sensor mount (x stays forward)
NUSC_VEHICLE_T_KITTI_LIDAR = np.eye(4)
NUSC_VEHICLE_T_KITTI_LIDAR[:3, 3] = [0.95, 0.0, 1.73]
KITTI_LIDAR_T_NUSC_VEHICLE = np.linalg.inv(NUSC_VEHICLE_T_KITTI_LIDAR)

DYNAMIC_PREFIXES = ("vehicle.", "human.pedestrian.", "animal",
                    "movable_object.")

FRAMERATE_HZ = 10.0
SKIP_T0_T1 = 2  # 20 Hz sweep chain -> 10 Hz pairs (create.py:323-325)
SKIP_T0_T2 = 4


def quat_to_mat(q) -> np.ndarray:
    """wxyz unit quaternion -> 3x3 rotation."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def pose_to_htm(rec) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = quat_to_mat(rec["rotation"])
    T[:3, 3] = rec["translation"]
    return T


def slerp(q0, q1, t):
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    th = np.arccos(np.clip(d, -1, 1))
    return (
        np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1
    ) / np.sin(th)


def interp_pose(t, t0, p0, t1, p1) -> np.ndarray:
    """Linear position + slerp rotation between two timestamped poses."""
    if t1 == t0:
        a = 0.0
    else:
        a = (t - t0) / (t1 - t0)
    T = np.eye(4)
    T[:3, 3] = (1 - a) * np.asarray(p0["translation"]) + a * np.asarray(
        p1["translation"]
    )
    T[:3, :3] = quat_to_mat(slerp(p0["rotation"], p1["rotation"], a))
    return T


class NuscTables:
    """Minimal devkit replacement: the JSON tables indexed by token
    (nuscenes_parser.NuScenesParser surface actually consumed)."""

    TABLES = ("scene", "sample", "sample_data", "ego_pose",
              "calibrated_sensor", "sample_annotation", "instance",
              "category")

    def __init__(self, dataroot, version="v1.0-mini"):
        self.dataroot = Path(dataroot)
        self.version = version
        tdir = self.dataroot / version
        for name in self.TABLES:
            rows = json.loads((tdir / f"{name}.json").read_text())
            setattr(self, name, rows)
            setattr(self, f"_{name}_by_tok", {r["token"]: r for r in rows})
        # LIDAR_TOP sample_data chain per scene, time-ordered
        self._lidar_sd_by_scene: Dict[str, List[dict]] = {}
        for sd in self.sample_data:
            if "LIDAR_TOP" not in sd.get("filename", ""):
                continue
            sample = self._sample_by_tok[sd["sample_token"]]
            self._lidar_sd_by_scene.setdefault(
                sample["scene_token"], []
            ).append(sd)
        for chain in self._lidar_sd_by_scene.values():
            chain.sort(key=lambda r: r["timestamp"])
        # annotations per instance, time-ordered (timestamp = its sample's)
        self._anns_by_instance: Dict[str, List[dict]] = {}
        for ann in self.sample_annotation:
            self._anns_by_instance.setdefault(
                ann["instance_token"], []
            ).append(ann)
        for anns in self._anns_by_instance.values():
            anns.sort(
                key=lambda a: self._sample_by_tok[a["sample_token"]][
                    "timestamp"
                ]
            )
        self._anns_by_sample: Dict[str, List[dict]] = {}
        for ann in self.sample_annotation:
            self._anns_by_sample.setdefault(ann["sample_token"], []).append(
                ann
            )

    def get(self, table, token):
        return getattr(self, f"_{table}_by_tok")[token]

    def lidar_chain(self, scene_token):
        return self._lidar_sd_by_scene[scene_token]

    def ego_pose_at(self, scene_token, timestamp) -> np.ndarray:
        """world_T_vehicle interpolated over the scene's lidar ego poses
        (parser get_ego_pose_at_timestamp)."""
        chain = self.lidar_chain(scene_token)
        poses = [self.get("ego_pose", sd["ego_pose_token"]) for sd in chain]
        ts = np.asarray([p["timestamp"] for p in poses])
        i = int(np.searchsorted(ts, timestamp))
        if i == 0:
            return pose_to_htm(poses[0])
        if i >= len(poses):
            return pose_to_htm(poses[-1])
        return interp_pose(
            timestamp, ts[i - 1], poses[i - 1], ts[i], poses[i]
        )

    def instance_pose_at(self, instance_token, timestamp) -> np.ndarray:
        """world_T_obj interpolated between the instance's 2 Hz keyframe
        annotations (parser get_interpolated_instance_poses__m). Raises
        ValueError outside the annotated interval (reference skips the
        sample on AssertionError, create.py:318-321)."""
        anns = self._anns_by_instance[instance_token]
        ts = np.asarray(
            [self._sample_by_tok[a["sample_token"]]["timestamp"]
             for a in anns]
        )
        if not (ts[0] - 1e5 <= timestamp <= ts[-1] + 1e5):
            raise ValueError("timestamp outside annotated interval")
        i = int(np.searchsorted(ts, timestamp))
        if i == 0:
            return pose_to_htm(anns[0])
        if i >= len(anns):
            return pose_to_htm(anns[-1])
        return interp_pose(timestamp, ts[i - 1], anns[i - 1], ts[i], anns[i])

    def box_velocity(self, ann) -> np.ndarray:
        """Global-frame velocity from neighbouring annotations (devkit
        box_velocity semantics: central difference, nan when isolated)."""
        anns = self._anns_by_instance[ann["instance_token"]]
        idx = next(
            i for i, a in enumerate(anns) if a["token"] == ann["token"]
        )
        lo = max(idx - 1, 0)
        hi = min(idx + 1, len(anns) - 1)
        if lo == hi:
            return np.full(3, np.nan)
        t_lo = self._sample_by_tok[anns[lo]["sample_token"]]["timestamp"]
        t_hi = self._sample_by_tok[anns[hi]["sample_token"]]["timestamp"]
        d = np.asarray(anns[hi]["translation"]) - np.asarray(
            anns[lo]["translation"]
        )
        return d / ((t_hi - t_lo) / 1e6)


def load_lidar_kitti_frame(tables: NuscTables, sd: dict):
    """.pcd.bin (x y z intensity ring f32) -> kitti-lidar frame points +
    intensities + rows; ego-close points removed (devkit remove_close 1 m).
    """
    raw = np.fromfile(
        tables.dataroot / sd["filename"], dtype=np.float32
    ).reshape(-1, 5)
    cs = tables.get("calibrated_sensor", sd["calibrated_sensor_token"])
    veh_T_sensor = pose_to_htm(cs)
    pts_sensor = raw[:, :3].astype(np.float64)
    keep = np.linalg.norm(pts_sensor[:, :2], axis=-1) > 1.0
    pts_veh = pts_sensor @ veh_T_sensor[:3, :3].T + veh_T_sensor[:3, 3]
    pts_kitti = (
        pts_veh @ KITTI_LIDAR_T_NUSC_VEHICLE[:3, :3].T
        + KITTI_LIDAR_T_NUSC_VEHICLE[:3, 3]
    )
    return (
        pts_kitti[keep].astype(np.float32),
        raw[keep, 3].astype(np.float32),
        raw[keep, 4].astype(np.uint8),
    )


def is_dynamic_category(name: str) -> bool:
    return any(name.startswith(p) for p in DYNAMIC_PREFIXES)


def _rigid_flow(pcl, odom_a_b):
    homog = np.concatenate([pcl.astype(np.float64),
                            np.ones((len(pcl), 1))], -1)
    return (homog @ (np.linalg.inv(odom_a_b) - np.eye(4)).T)[:, :3], homog


def convert_sample(
    tables: NuscTables,
    sample: dict,
    target_dir: Path,
    icp_poses: Optional[dict] = None,
):
    """One keyframe -> one npy dict; returns a status string like the
    reference (create.py returns 'fine' / skip reasons)."""
    scene = tables.get("scene", sample["scene_token"])
    sd0 = tables.get("sample_data", sample["data"]["LIDAR_TOP"])
    chain = tables.lidar_chain(sample["scene_token"])
    i0 = next(
        i for i, sd in enumerate(chain) if sd["token"] == sd0["token"]
    )
    if i0 + SKIP_T0_T2 >= len(chain):
        return "not enough follow up sample datas"
    sd1, sd2 = chain[i0 + SKIP_T0_T1], chain[i0 + SKIP_T0_T2]
    t0, t1, t2 = sd0["timestamp"], sd1["timestamp"], sd2["timestamp"]
    if abs((t1 - t0) - 1e6 / FRAMERATE_HZ) > 1e6 / FRAMERATE_HZ * 0.2:
        return "irregular temporal sampling"

    w_T_v = {
        k: tables.ego_pose_at(sample["scene_token"], t)
        for k, t in (("t0", t0), ("t1", t1), ("t2", t2))
    }
    w_T_lid = {k: v @ NUSC_VEHICLE_T_KITTI_LIDAR for k, v in w_T_v.items()}

    pcls, intens, rows, grounds = {}, {}, {}, {}
    for key, sd in (("t0", sd0), ("t1", sd1), ("t2", sd2)):
        p, inten, row = load_lidar_kitti_frame(tables, sd)
        pcls[key], intens[key], rows[key] = p, inten, row
        grounds[key] = jpc_ground_remove(p[:, :3].astype(np.float64))

    odom = {}
    for a, b in (("t0", "t1"), ("t0", "t2"), ("t1", "t2")):
        odom[(a, b)] = np.linalg.inv(w_T_lid[a]) @ w_T_lid[b]

    flows, homogs = {}, {}
    for a, b in (("t0", "t1"), ("t1", "t0"), ("t0", "t2"), ("t2", "t0"),
                 ("t1", "t2"), ("t2", "t1")):
        o = odom[(a, b)] if (a, b) in odom else np.linalg.inv(
            odom[(b, a)]
        )
        flows[(a, b)], homogs[a] = _rigid_flow(pcls[a], o)

    track_masks = {
        k: np.zeros(len(pcls[k]), np.uint8) for k in ("t0", "t1", "t2")
    }
    ts_by_key = {"t0": t0, "t1": t1, "t2": t2}

    objects = []
    for ann_idx, ann in enumerate(
        tables._anns_by_sample.get(sample["token"], [])
    ):
        category = ann["category_name"]
        if not is_dynamic_category(category):
            continue
        size = np.asarray(ann["size"], np.float64)[[1, 0, 2]]  # wlh -> lwh
        lid_T_obj = {}
        try:
            for k in ("t0", "t1", "t2"):
                w_T_obj = (
                    pose_to_htm(ann)
                    if k == "t0"
                    else tables.instance_pose_at(
                        ann["instance_token"], ts_by_key[k]
                    )
                )
                lid_T_obj[k] = np.linalg.inv(w_T_lid[k]) @ w_T_obj
        except ValueError:
            return "pose interpolation failed"
        # override the rigid flow inside the box with the box motion
        for a, b in (("t0", "t1"), ("t1", "t0"), ("t0", "t2"),
                     ("t2", "t0"), ("t1", "t2"), ("t2", "t1")):
            local = homogs[a] @ np.linalg.inv(lid_T_obj[a]).T
            in_box = (np.abs(local[:, :3]) < size / 2.0).all(axis=-1)
            if not in_box.any():
                continue
            trafo = lid_T_obj[b] @ np.linalg.inv(lid_T_obj[a])
            dyn = (homogs[a] @ (trafo - np.eye(4)).T)[:, :3]
            flows[(a, b)][in_box] = dyn[in_box]
            track_masks[a][in_box] = ann_idx
        objects.append(
            {
                "pose_t0": lid_T_obj["t0"],
                "pose_t1": lid_T_obj["t1"],
                "pose_t2": lid_T_obj["t2"],
                "size": size,
                "annotation_idx": ann_idx,
                "annotation_token": ann["token"],
                "category": category,
                "box_velocity": tables.box_velocity(ann),
            }
        )

    sample_tokens = [
        s["token"] for s in tables.sample
        if s["scene_token"] == sample["scene_token"]
    ]
    name = "%s_%02d_%s" % (
        scene["name"], sample_tokens.index(sample["token"]), sample["token"]
    )
    d = {
        "name": name,
        "objects": np.asarray(objects, dtype=object),
    }
    for k in ("t0", "t1", "t2"):
        d[f"pcl_{k}"] = np.concatenate(
            [pcls[k], intens[k][:, None]], -1
        ).astype(np.float32)
        d[f"lidar_rows_{k}"] = rows[k]
        d[f"is_ground_{k}"] = grounds[k].astype(bool)
        d[f"track_ids_mask_{k}"] = track_masks[k]
    for (a, b), fl in flows.items():
        d[f"flow_{a}_{b}"] = fl.astype(np.float32)
    d["odom_t0_t1"] = odom[("t0", "t1")].astype(np.float64)
    d["odom_t0_t2"] = odom[("t0", "t2")].astype(np.float64)
    d["odom_t1_t2"] = odom[("t1", "t2")].astype(np.float64)
    for a, b in (("t0", "t1"), ("t0", "t2"), ("t1", "t2")):
        key = (a, b)
        if icp_poses is not None:
            ia = chain[i0 + {"t0": 0, "t1": SKIP_T0_T1}[a]]["token"]
            ib = chain[i0 + {"t1": SKIP_T0_T1, "t2": SKIP_T0_T2}[b]][
                "token"
            ]
            o = np.linalg.inv(icp_poses[ia]) @ icp_poses[ib]
        else:
            o = odom[key]
        d[f"kiss_odom_{a}_{b}"] = o
        d[f"kiss_odom_{b}_{a}"] = np.linalg.inv(o)
    target_dir.mkdir(parents=True, exist_ok=True)
    np.save(target_dir / name, d)
    return "fine"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nusc_root", required=True, type=Path)
    ap.add_argument("--target_dir", required=True, type=Path)
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument(
        "--splits", default=None, type=Path,
        help='JSON {"train": [scene names], "val": [...]} — official '
             "devkit split lists; omitted -> flat output dir",
    )
    ap.add_argument("--use_icp", action="store_true")
    args = ap.parse_args(argv)
    tables = NuscTables(args.nusc_root, args.version)
    split_of_scene = {}
    if args.splits:
        for cat, scenes in json.loads(args.splits.read_text()).items():
            for s in scenes:
                assert s not in split_of_scene, f"{s} in two splits"
                split_of_scene[s] = cat

    icp_poses = None
    if args.use_icp:
        from liso_tpu_torch.data.icp import icp_odometry

        icp_poses = {}
        for scene_token, chain in tables._lidar_sd_by_scene.items():
            clouds = [
                load_lidar_kitti_frame(tables, sd)[0][:, :3].astype(
                    np.float64
                )
                for sd in chain
            ]
            for sd, pose in zip(chain, icp_odometry(clouds)):
                icp_poses[sd["token"]] = pose

    counts: Dict[str, int] = {}
    for sample in tables.sample:
        scene = tables.get("scene", sample["scene_token"])
        sub = split_of_scene.get(scene["name"], "")
        out = args.target_dir / "nuscenes" / sub if sub else (
            args.target_dir / "nuscenes"
        )
        r = convert_sample(tables, sample, out, icp_poses)
        counts[r] = counts.get(r, 0) + 1
    print(counts)


if __name__ == "__main__":
    main()
