"""Argoverse 2 sensor-dataset ETL -> per-sample npy dicts, devkit-free.

Behavioral reference: liso/datasets/argoverse2/create.py (428 LoC, uses the
av2 devkit's AV2SensorDataLoader + kiss-icp + JCP). The av2 pip package is
not available in this environment, but the AV2 sensor dataset is plain
feather files, so this script reads them directly with pyarrow:

  <log_id>/sensors/lidar/<timestamp_ns>.feather   x, y, z, intensity,
                                                  laser_number, offset_ns
  <log_id>/city_SE3_egovehicle.feather            timestamp_ns, qw qx qy qz,
                                                  tx_m ty_m tz_m
  <log_id>/annotations.feather                    timestamp_ns, category,
                                                  length_m width_m height_m,
                                                  qw..., tx_m..., num_interior_pts

Lidar xyz and annotations are both in the ego frame, so "sensor" == ego
here (same convention as the reference's Sweep.from_feather usage). Output
npy schema matches data/create_kitti.py (+ objects_t* GT records consumed by
liso_tpu_torch.data.waymo.AV2Dataset / kitti._boxes_from_objects).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from liso_tpu_torch.data.ground import jpc_ground_remove
from liso_tpu_torch.data.icp import icp_odometry

AV2_MOVABLE_CLASSES = (
    "REGULAR_VEHICLE", "PEDESTRIAN", "BICYCLIST", "MOTORCYCLIST",
    "WHEELED_RIDER", "BOLLARD", "LARGE_VEHICLE", "BUS", "BOX_TRUCK",
    "TRUCK", "VEHICULAR_TRAILER", "TRUCK_CAB", "SCHOOL_BUS",
    "ARTICULATED_BUS", "MOTORCYCLE", "BICYCLE", "WHEELED_DEVICE", "DOG",
    "STROLLER", "WHEELCHAIR",
)


def _read_feather(path: Path):
    import pyarrow.feather as feather

    return feather.read_table(path).to_pydict()


def quat_wxyz_to_matrix(qw, qx, qy, qz) -> np.ndarray:
    n = max(np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz), 1e-12)
    w, x, y, z = qw / n, qx / n, qy / n, qz / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _pose_from_row(d: dict, i: int) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = quat_wxyz_to_matrix(
        d["qw"][i], d["qx"][i], d["qy"][i], d["qz"][i]
    )
    T[:3, 3] = [d["tx_m"][i], d["ty_m"][i], d["tz_m"][i]]
    return T


def load_city_poses(log_dir: Path) -> dict:
    """timestamp_ns -> city_T_ego [4, 4]."""
    d = _read_feather(log_dir / "city_SE3_egovehicle.feather")
    return {
        int(ts): _pose_from_row(d, i)
        for i, ts in enumerate(d["timestamp_ns"])
    }


def load_annotations(log_dir: Path) -> dict:
    """timestamp_ns -> objects record {poses, size, category}."""
    path = log_dir / "annotations.feather"
    out: dict = {}
    if not path.exists():
        return out
    d = _read_feather(path)
    for i, ts in enumerate(d["timestamp_ns"]):
        T = _pose_from_row(d, i)
        rec = out.setdefault(
            int(ts), {"poses": [], "size": [], "category": []}
        )
        rec["poses"].append(T)
        rec["size"].append(
            [d["length_m"][i], d["width_m"][i], d["height_m"][i]]
        )
        rec["category"].append(str(d["category"][i]))
    return {
        ts: {
            "poses": np.stack(r["poses"]),
            "size": np.asarray(r["size"], np.float32),
            "category": np.asarray(r["category"]),
        }
        for ts, r in out.items()
    }


def load_sweep(path: Path):
    """-> (pcl [N, 4] xyz+intensity f32, lidar_rows [N] int32)."""
    d = _read_feather(path)
    pcl = np.stack(
        [
            np.asarray(d["x"], np.float32),
            np.asarray(d["y"], np.float32),
            np.asarray(d["z"], np.float32),
            np.asarray(d["intensity"], np.float32) / 255.0,
        ],
        axis=1,
    )
    rows = np.asarray(d.get("laser_number", np.zeros(len(pcl))), np.int32)
    return pcl, rows


def convert_log(
    log_dir: Path,
    target_dir: Path,
    use_icp: bool = True,
    max_samples: int | None = None,
) -> int:
    """One AV2 log -> npy samples named <log_id>_<timestamp_ns>."""
    lidar_files = sorted((log_dir / "sensors" / "lidar").glob("*.feather"))
    if len(lidar_files) < 3:
        return 0
    city_T_ego = load_city_poses(log_dir)
    anno = load_annotations(log_dir)
    log_id = log_dir.name

    kiss_poses = None
    if use_icp:
        try:
            kiss_poses = icp_odometry(
                [load_sweep(f)[0][:, :3] for f in lidar_files]
            )
        except Exception as e:  # native lib absent: ego poses still work
            print(f"icp odometry unavailable ({e}); using ego poses")

    cache: dict = {}

    def get(i):
        if i not in cache:
            pcl, rows = load_sweep(lidar_files[i])
            cache[i] = (pcl, rows, jpc_ground_remove(pcl[:, :3]))
        return cache[i]

    def ego_pose(i):
        ts = int(lidar_files[i].stem)
        return city_T_ego.get(ts, np.eye(4)), ts

    target_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for i in range(len(lidar_files) - 2):
        if max_samples is not None and n >= max_samples:
            break
        p0, r0, g0 = get(i)
        p1, r1, g1 = get(i + 1)
        p2, r2, g2 = get(i + 2)
        T0, ts0 = ego_pose(i)
        T1, _ = ego_pose(i + 1)
        T2, _ = ego_pose(i + 2)
        d = {
            "pcl_t0": p0,
            "pcl_t1": p1,
            "pcl_t2": p2,
            "lidar_rows_t0": r0,
            "lidar_rows_t1": r1,
            "lidar_rows_t2": r2,
            "is_ground_t0": g0,
            "is_ground_t1": g1,
            "is_ground_t2": g2,
            "odom_t0_t1": np.linalg.inv(T0) @ T1,
            "odom_t0_t2": np.linalg.inv(T0) @ T2,
            "name": f"{log_id}_{ts0}",
        }
        for a, b, Ta, Tb in ((0, 1, T0, T1), (0, 2, T0, T2), (1, 2, T1, T2)):
            if kiss_poses is not None:
                o = np.linalg.inv(kiss_poses[i + a]) @ kiss_poses[i + b]
            else:
                o = np.linalg.inv(Ta) @ Tb
            d[f"kiss_odom_t{a}_t{b}"] = o
            d[f"kiss_odom_t{b}_t{a}"] = np.linalg.inv(o)
        for tk, idx in (("t0", i), ("t1", i + 1), ("t2", i + 2)):
            ts = int(lidar_files[idx].stem)
            if ts in anno:
                d[f"objects_{tk}"] = anno[ts]
        np.save(target_dir / d["name"], d)
        cache.pop(i, None)
        n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--av2_root", required=True,
                   help="dir containing <log_id>/sensors/lidar/*.feather")
    p.add_argument("--target_dir", required=True)
    p.add_argument("--no-icp", action="store_true")
    p.add_argument("--world_size", type=int, default=1)
    p.add_argument("--worker_id", type=int, default=0)
    args = p.parse_args(argv)

    logs = sorted(
        d for d in Path(args.av2_root).iterdir()
        if (d / "sensors" / "lidar").is_dir()
    )
    total = 0
    for k, log_dir in enumerate(logs):
        if k % args.world_size != args.worker_id:
            continue  # embarrassingly parallel job sharding (README.md:133)
        total += convert_log(
            log_dir, Path(args.target_dir) / "av2", use_icp=not args.no_icp
        )
    print(f"converted {total} samples from {len(logs)} logs")
    return total


if __name__ == "__main__":
    main()
