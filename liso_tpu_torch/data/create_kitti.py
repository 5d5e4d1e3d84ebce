"""Offline ETL: KITTI raw -> per-sample npy dicts (training format).

Behavioral reference: liso/datasets/kitti/create_kitti_raw.py:39-177. Output
format is identical (pcl_t0/t1/t2 f32, is_ground_* bool, odom_t0_t1/t0_t2
f64, kiss_odom_* f64, name). Differences: pykitti is replaced by direct
parsing of velodyne .bin / oxts .txt / calib files (pykitti is not in this
environment), the numba JCP ground removal by the vectorised
liso_tpu_torch.data.ground, and KISS-ICP odometry by the point-to-point ICP in
liso_tpu_torch.data.icp (native-accelerated when built); both odometry sources are
stored like the reference so downstream can select odom_source.

Usage:
  python -m liso_tpu_torch.data.create_kitti --kitti_raw_root R --target_dir T
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from liso_tpu_torch.data.ground import jpc_ground_remove

EARTH_RADIUS = 6378137.0


def load_velo(path) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def oxts_to_pose(lines) -> np.ndarray:
    """OXTS GPS/IMU packets -> [T, 4, 4] world_T_imu (mercator projection,
    same math as pykitti.utils.load_oxts_packets_and_poses)."""
    scale = None
    origin = None
    poses = []
    for line in lines:
        v = [float(x) for x in line.strip().split()[:6]]
        lat, lon, alt, roll, pitch, yaw = v
        if scale is None:
            scale = np.cos(lat * np.pi / 180.0)
        tx = scale * lon * np.pi * EARTH_RADIUS / 180.0
        ty = scale * EARTH_RADIUS * np.log(
            np.tan((90.0 + lat) * np.pi / 360.0)
        )
        tz = alt
        t = np.array([tx, ty, tz])
        if origin is None:
            origin = t.copy()
        Rx = _rot_x(roll)
        Ry = _rot_y(pitch)
        Rz = _rot_z(yaw)
        R = Rz @ Ry @ Rx
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t - origin
        poses.append(T)
    return np.stack(poses)


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def read_calib_rigid(path) -> np.ndarray:
    """calib_imu_to_velo.txt -> 4x4."""
    vals = {}
    for line in Path(path).read_text().splitlines():
        if ":" in line:
            k, v = line.split(":", 1)
            try:
                vals[k.strip()] = np.array([float(x) for x in v.split()])
            except ValueError:
                pass
    T = np.eye(4)
    T[:3, :3] = vals["R"].reshape(3, 3)
    T[:3, 3] = vals["T"]
    return T


def convert_drive(drive_dir: Path, target_dir: Path, icp_odometry=None):
    """One raw drive (date/date_drive_XXXX_sync) -> npy samples."""
    date_dir = drive_dir.parent
    velo_files = sorted((drive_dir / "velodyne_points" / "data").glob("*.bin"))
    oxts_files = sorted((drive_dir / "oxts" / "data").glob("*.txt"))
    assert len(velo_files) == len(oxts_files), (drive_dir, len(velo_files),
                                                len(oxts_files))
    if len(velo_files) < 3:
        return 0
    w_T_imu = oxts_to_pose([f.read_text() for f in oxts_files])
    velo_T_imu = read_calib_rigid(date_dir / "calib_imu_to_velo.txt")
    imu_T_velo = np.linalg.inv(velo_T_imu)
    w_T_velo = w_T_imu @ imu_T_velo[None]

    pcls = {}
    grounds = {}

    def get(i):
        if i not in pcls:
            pcls[i] = load_velo(velo_files[i])
            grounds[i] = jpc_ground_remove(pcls[i][:, :3])
        return pcls[i], grounds[i]

    # optional ICP odometry over the whole drive
    kiss_poses = None
    if icp_odometry is not None:
        kiss_poses = icp_odometry([load_velo(f)[:, :3] for f in velo_files])

    prefix = drive_dir.name.replace("_sync", "")
    n = 0
    target_dir.mkdir(parents=True, exist_ok=True)
    for i in range(len(velo_files) - 2):
        p0, g0 = get(i)
        p1, g1 = get(i + 1)
        p2, g2 = get(i + 2)
        d = {
            "pcl_t0": p0,
            "pcl_t1": p1,
            "pcl_t2": p2,
            "is_ground_t0": g0,
            "is_ground_t1": g1,
            "is_ground_t2": g2,
            "odom_t0_t1": np.linalg.inv(w_T_velo[i]) @ w_T_velo[i + 1],
            "odom_t0_t2": np.linalg.inv(w_T_velo[i]) @ w_T_velo[i + 2],
            "name": f"{prefix}_{velo_files[i].stem}",
        }
        if kiss_poses is not None:
            for a, b in ((0, 1), (0, 2), (1, 2)):
                o = np.linalg.inv(kiss_poses[i + a]) @ kiss_poses[i + b]
                d[f"kiss_odom_t{a}_t{b}"] = o
                d[f"kiss_odom_t{b}_t{a}"] = np.linalg.inv(o)
        else:  # fall back to GPS odometry for the kiss keys
            for a, b in ((0, 1), (0, 2), (1, 2)):
                o = np.linalg.inv(w_T_velo[i + a]) @ w_T_velo[i + b]
                d[f"kiss_odom_t{a}_t{b}"] = o
                d[f"kiss_odom_t{b}_t{a}"] = np.linalg.inv(o)
        np.save(target_dir / d["name"], d)
        pcls.pop(i, None)
        grounds.pop(i, None)
        n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kitti_raw_root", required=True, type=Path)
    ap.add_argument("--target_dir", required=True, type=Path)
    ap.add_argument("--use_icp", action="store_true")
    args = ap.parse_args(argv)
    target = args.target_dir / "kitti_raw"
    icp = None
    if args.use_icp:
        from liso_tpu_torch.data.icp import icp_odometry

        icp = icp_odometry
    total = 0
    for date_dir in sorted(args.kitti_raw_root.glob("2011_*")):
        for drive in sorted(date_dir.glob("*_sync")):
            total += convert_drive(drive, target, icp)
    print(f"wrote {total} samples to {target}")


if __name__ == "__main__":
    main()
