"""Offline ETL: KITTI tracking -> per-sample npy dicts with GT object flow.

Behavioral reference: liso/datasets/kitti/create_kitti_tracking.py:1-459.
Output schema is identical: pcl_t0/t1/t2 (f32 [N,4]), flow_t0_t1/t1_t0/
t0_t2/t2_t0 GT scene flow derived from annotated box motion (rigid ego flow
outside boxes, per-track box-motion flow inside — extract_lidar_flow_ta_tb
:345-395), track_ids_mask_* (uint16, dummy=65535 outside boxes),
is_ground_*, odom_t0_t1/t0_t2 (OXTS), kiss_odom_* (ICP), objects_t0/t1/t2
{poses [K,4,4], size [K,3] lwh, track_ids, category}, name "SSSS_FFFFFF".

Devkit-free differences: pykitti is replaced by direct parsing of the
tracking layout (velodyne/SSSS/*.bin, label_02/SSSS.txt, calib/SSSS.txt,
oxts/SSSS.txt); KISS-ICP by liso_tpu_torch.data.icp (native voxel-hash ICP);
numba JCP by the vectorised liso_tpu_torch.data.ground. Object poses use the
rectified-cam0 convention (velo_T_obj = inv(R_rect @ Tr_velo_cam) @
cam_T_obj); the reference uses pykitti's cam2 chain which differs only by
the stereo baseline x-offset folded into both GT and predictions.

Usage:
  python -m liso_tpu_torch.data.create_kitti_tracking \
      --kitti_tracking_root .../kitti_tracking/training --target_dir T
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List

import numpy as np

from liso_tpu_torch.data.create_kitti import load_velo, oxts_to_pose
from liso_tpu_torch.data.ground import jpc_ground_remove

DUMMY_TRACK_ID = np.iinfo(np.uint16).max

# frame drops in sequence 0001 (create_kitti_tracking.py:39-51)
SEQ_0001_MISSING = (177, 178, 179, 180)


def corrected_lidar_frame_idx(seq: str, raw_frame_idx: int):
    if seq == "0001":
        if raw_frame_idx in SEQ_0001_MISSING:
            return None
        if raw_frame_idx > 180:
            return raw_frame_idx - 4
    return raw_frame_idx


def read_tracking_calib(path: Path) -> Dict[str, np.ndarray]:
    """calib/SSSS.txt -> {velo_T_cam (rect), imu_T_velo}."""
    vals = {}
    for line in path.read_text().splitlines():
        if not line.strip():
            continue
        key, _, rest = line.partition(" ")
        key = key.rstrip(":")
        vals[key] = np.fromstring(rest, sep=" ")
    r_rect = np.eye(4)
    r_rect[:3, :3] = vals["R_rect"].reshape(3, 3)
    tr = np.eye(4)
    tr[:3, :4] = vals["Tr_velo_cam"].reshape(3, 4)
    cam_T_velo = r_rect @ tr
    tr_imu = np.eye(4)
    tr_imu[:3, :4] = vals["Tr_imu_velo"].reshape(3, 4)
    return {
        "velo_T_cam": np.linalg.inv(cam_T_velo),
        "velo_T_imu": tr_imu,
    }


def parse_tracking_labels(path: Path) -> Dict[int, List[dict]]:
    """label_02/SSSS.txt -> {frame: [obj dicts]} (KITTI tracking format:
    frame track_id type trunc occl alpha bbox(4) h w l x y z rot_y)."""
    per_frame: Dict[int, List[dict]] = {}
    for line in path.read_text().splitlines():
        f = line.split()
        if len(f) < 17:
            continue
        frame, track_id, typ = int(f[0]), int(f[1]), f[2]
        if typ == "DontCare" or track_id < 0:
            continue
        h, w, l = float(f[10]), float(f[11]), float(f[12])
        x, y, z = float(f[13]), float(f[14]), float(f[15])
        rot_y = float(f[16])
        per_frame.setdefault(frame, []).append(
            dict(track_id=track_id, category=typ, dims_lwh=(l, w, h),
                 loc_cam=(x, y, z), rot_y=rot_y)
        )
    return per_frame


def cam_T_obj_from_label(obj) -> np.ndarray:
    """Object pose in camera coords; KITTI boxes are bottom-centered in y
    (get_kitti_tracking_object_cam_pose:21-37: y -= h/2 to center)."""
    x, y, z = obj["loc_cam"]
    l, w, h = obj["dims_lwh"]
    T = np.eye(4)
    T[:3, 3] = [x, y - h / 2.0, z]
    c, s = np.cos(obj["rot_y"]), np.sin(obj["rot_y"])
    T[0, 0], T[0, 2] = c, s
    T[2, 0], T[2, 2] = -s, c
    return T


def objects_for_frame(labels, frame, velo_T_cam):
    objs = labels.get(frame, [])
    if not objs:
        return {
            "poses": np.zeros((0, 4, 4), np.float64),
            "size": np.zeros((0, 3), np.float64),
            "track_ids": np.zeros((0,), np.int64),
            "category": np.zeros((0,), dtype="<U32"),
        }
    poses = np.stack([velo_T_cam @ cam_T_obj_from_label(o) for o in objs])
    return {
        "poses": poses,
        "size": np.asarray([o["dims_lwh"] for o in objs], np.float64),
        "track_ids": np.asarray([o["track_id"] for o in objs], np.int64),
        "category": np.asarray([o["category"] for o in objs]),
    }


def points_in_box_mask(pcl_homog, lidar_T_obj, size_lwh):
    """create_kitti_tracking.get_points_in_box_mask:14-17."""
    local = pcl_homog @ np.linalg.inv(lidar_T_obj).T
    return (np.abs(local[:, :3]) < np.asarray(size_lwh) / 2.0).all(axis=-1)


def extract_lidar_flow(pcl_homog_a, objs_a, objs_b, odom_a_b):
    """GT scene flow a->b from annotated box motion
    (create_kitti_tracking.extract_lidar_flow_ta_tb:345-395): rigid ego
    flow everywhere, overridden inside each box whose track persists by
    the box-motion transform. Returns (flow [N,3] f32, track mask u16)."""
    flow = (pcl_homog_a @ (np.linalg.inv(odom_a_b) - np.eye(4)).T)[:, :3]
    mask = np.full(len(pcl_homog_a), DUMMY_TRACK_ID, np.uint16)
    ids_b = list(objs_b["track_ids"])
    for k, tid in enumerate(objs_a["track_ids"]):
        in_box = points_in_box_mask(
            pcl_homog_a, objs_a["poses"][k], objs_a["size"][k]
        )
        mask = np.where(in_box, np.uint16(tid), mask)
        if tid in ids_b:
            kb = ids_b.index(tid)
            trafo = objs_b["poses"][kb] @ np.linalg.inv(objs_a["poses"][k])
            dyn = (pcl_homog_a @ (trafo - np.eye(4)).T)[:, :3]
            flow = np.where(in_box[:, None], dyn, flow)
    return flow.astype(np.float32), mask


def convert_sequence(
    seq_root: Path, seq: str, target_dir: Path, icp_odometry=None
):
    velo_dir = seq_root / "velodyne" / seq
    velo_files = sorted(velo_dir.glob("*.bin"))
    if len(velo_files) < 3:
        return 0
    calib = read_tracking_calib(seq_root / "calib" / f"{seq}.txt")
    labels = parse_tracking_labels(seq_root / "label_02" / f"{seq}.txt")
    oxts_path = seq_root / "oxts" / f"{seq}.txt"
    w_T_velo = None
    if oxts_path.exists():
        w_T_imu = oxts_to_pose(oxts_path.read_text().splitlines())
        imu_T_velo = np.linalg.inv(calib["velo_T_imu"])
        w_T_velo = w_T_imu @ imu_T_velo[None]

    kiss_poses = None
    if icp_odometry is not None:
        kiss_poses = icp_odometry(
            [load_velo(f)[:, :3] for f in velo_files]
        )

    cache: Dict[int, tuple] = {}

    def get(lidar_idx, obj_frame_idx):
        if lidar_idx not in cache:
            pcl = load_velo(velo_files[lidar_idx])
            homog = np.concatenate(
                [pcl[:, :3].astype(np.float64),
                 np.ones((len(pcl), 1))], -1
            )
            ground = jpc_ground_remove(pcl[:, :3])
            objs = objects_for_frame(
                labels, obj_frame_idx, calib["velo_T_cam"]
            )
            cache[lidar_idx] = (pcl, homog, ground, objs)
        return cache[lidar_idx]

    target_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    n_frames = len(velo_files)
    for obj_frame in range(n_frames + len(SEQ_0001_MISSING)):
        li0 = corrected_lidar_frame_idx(seq, obj_frame)
        li1 = corrected_lidar_frame_idx(seq, obj_frame + 1)
        li2 = corrected_lidar_frame_idx(seq, obj_frame + 2)
        if li0 is None or li1 is None or li2 is None:
            continue
        if li2 >= n_frames:
            break
        p0, h0, g0, o0 = get(li0, obj_frame)
        p1, h1, g1, o1 = get(li1, obj_frame + 1)
        p2, h2, g2, o2 = get(li2, obj_frame + 2)

        if w_T_velo is not None and obj_frame + 2 < len(w_T_velo):
            odom_t0_t1 = np.linalg.inv(w_T_velo[obj_frame]) @ w_T_velo[
                obj_frame + 1
            ]
            odom_t0_t2 = np.linalg.inv(w_T_velo[obj_frame]) @ w_T_velo[
                obj_frame + 2
            ]
        elif kiss_poses is not None:
            odom_t0_t1 = np.linalg.inv(kiss_poses[li0]) @ kiss_poses[li1]
            odom_t0_t2 = np.linalg.inv(kiss_poses[li0]) @ kiss_poses[li2]
        else:
            odom_t0_t1 = np.eye(4)
            odom_t0_t2 = np.eye(4)

        fl01, m0 = extract_lidar_flow(h0, o0, o1, odom_t0_t1)
        fl10, m1 = extract_lidar_flow(
            h1, o1, o0, np.linalg.inv(odom_t0_t1)
        )
        fl02, m0b = extract_lidar_flow(h0, o0, o2, odom_t0_t2)
        assert (m0 == m0b).all()
        fl20, m2 = extract_lidar_flow(
            h2, o2, o0, np.linalg.inv(odom_t0_t2)
        )

        name = f"{seq}_{str(li0).zfill(6)}"
        d = {
            "pcl_t0": p0.astype(np.float32),
            "pcl_t1": p1.astype(np.float32),
            "pcl_t2": p2.astype(np.float32),
            "flow_t0_t1": fl01,
            "flow_t1_t0": fl10,
            "flow_t0_t2": fl02,
            "flow_t2_t0": fl20,
            "track_ids_mask_t0": m0,
            "track_ids_mask_t1": m1,
            "track_ids_mask_t2": m2,
            "is_ground_t0": g0,
            "is_ground_t1": g1,
            "is_ground_t2": g2,
            "odom_t0_t1": odom_t0_t1.astype(np.float64),
            "odom_t0_t2": odom_t0_t2.astype(np.float64),
            "objects_t0": o0,
            "objects_t1": o1,
            "objects_t2": o2,
            "name": name,
        }
        if kiss_poses is not None:
            for (a, ia), (b, ib) in (
                ((0, li0), (1, li1)), ((0, li0), (2, li2)),
                ((1, li1), (2, li2)),
            ):
                o = np.linalg.inv(kiss_poses[ia]) @ kiss_poses[ib]
                d[f"kiss_odom_t{a}_t{b}"] = o
                d[f"kiss_odom_t{b}_t{a}"] = np.linalg.inv(o)
        else:
            for a, b in ((0, 1), (0, 2), (1, 2)):
                o = d.get(f"odom_t{a}_t{b}")
                if o is None:
                    o = np.linalg.inv(d["odom_t0_t1"]) @ d["odom_t0_t2"]
                d[f"kiss_odom_t{a}_t{b}"] = o
                d[f"kiss_odom_t{b}_t{a}"] = np.linalg.inv(o)
        np.save(target_dir / name, d)
        cache.pop(li0, None)
        n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kitti_tracking_root", required=True, type=Path,
                    help=".../kitti_tracking/training")
    ap.add_argument("--target_dir", required=True, type=Path)
    ap.add_argument("--use_icp", action="store_true")
    ap.add_argument("--sequences", nargs="*", default=None)
    args = ap.parse_args(argv)
    seqs = args.sequences or [str(i).zfill(4) for i in range(21)]
    icp = None
    if args.use_icp:
        from liso_tpu_torch.data.icp import icp_odometry

        icp = icp_odometry
    target = args.target_dir / "kitti_tracking"
    total = 0
    for seq in seqs:
        total += convert_sequence(
            args.kitti_tracking_root, seq, target, icp
        )
    print(f"wrote {total} samples to {target}")


if __name__ == "__main__":
    main()
