"""Offline ETL: Waymo Open (OpenPCDet preprocessing) -> per-sample npy.

Behavioral reference: liso/datasets/waymo_torch_dataset.py. The reference
consumes OpenPCDet's `waymo_processed_data_v0_5_0` layout lazily at train
time — per-sequence `{seq}/{seq}.pkl` label infos + per-frame
`{seq}/{idx:04d}.npy` point clouds — and generates KISS-ICP poses, JCP
ground masks and GT flow on the fly (waymo_torch_dataset.py:295-335,
751-822). This converter does that generation OFFLINE into the shared
triplet npy format every other dataset here uses, so the train-time
dataset needs no lazy side-channel caches:

  pcl_t0/t1/t2 (waymo-lidar frame: vehicle shifted by
  vehicle_Twaymo_lidar = translate(1.751, 0, 1.765),
  waymo_torch_dataset.py:34-61), is_ground_* (JCP), odom_* from frame
  poses, kiss_odom_* (native ICP), flow_* GT scene flow from per-track
  box motion (get_flow_waymo semantics), objects_t* grouped
  {poses, size lwh, track_ids, category, velo, difficulty, num_pts},
  name "{sequence}_{idx:04d}".

Usage:
  python -m liso_tpu_torch.data.create_waymo \
      --processed_root .../waymo_processed_data_v0_5_0 --target_dir T
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from liso_tpu_torch.data.ground import jpc_ground_remove

VEHICLE_T_WAYMO_LIDAR = np.eye(4)
VEHICLE_T_WAYMO_LIDAR[:3, 3] = [1.751, 0.0, 1.765]
WAYMO_LIDAR_T_VEHICLE = np.linalg.inv(VEHICLE_T_WAYMO_LIDAR)

MOVABLE_CLASSES = ("Vehicle", "Pedestrian", "Cyclist")


def load_frame_pcl(processed_root: Path, info: dict) -> np.ndarray:
    """Per-frame npy -> [N,4] (x,y,z,intensity) in the waymo-lidar frame,
    TOP lidar returns only (load_waymo_pcl_into_lidar_frame:420-430)."""
    pc = info["point_cloud"]
    path = processed_root / pc["lidar_sequence"] / (
        "%04d.npy" % pc["sample_idx"]
    )
    raw = np.load(path)
    n_top = int(np.asarray(info["num_points_of_each_lidar"]).reshape(-1)[0])
    pcl = np.array(raw[:n_top, :4], np.float32)
    pcl[:, :3] = (
        pcl[:, :3].astype(np.float64) @ WAYMO_LIDAR_T_VEHICLE[:3, :3].T
        + WAYMO_LIDAR_T_VEHICLE[:3, 3]
    ).astype(np.float32)
    return pcl


def extract_objects(info: dict):
    """annos -> grouped dict in the waymo-lidar frame
    (get_nonempty_flow_relevant_boxes_into_lidar_frame:869-913)."""
    annos = info.get("annos")
    empty = {
        "poses": np.zeros((0, 4, 4), np.float64),
        "size": np.zeros((0, 3), np.float64),
        "track_ids": np.zeros((0,), dtype="<U32"),
        "category": np.zeros((0,), dtype="<U32"),
        "velo": np.zeros((0, 1), np.float64),
        "difficulty": np.zeros((0, 1), np.int32),
        "num_pts": np.zeros((0,), np.int64),
    }
    if annos is None or len(annos.get("name", ())) == 0:
        return empty
    names = np.asarray(annos["name"]).astype(str)
    boxes = np.asarray(annos["gt_boxes_lidar"], np.float64).reshape(-1, 7)
    num_pts = np.asarray(annos["num_points_in_gt"]).reshape(-1)
    diff = np.asarray(annos["difficulty"], np.int32).reshape(-1)
    ids = np.asarray(annos["obj_ids"]).astype(str)
    speed = np.asarray(annos.get("speed_global", np.zeros((len(names), 2))))
    if speed.size == 0:
        speed = np.zeros((len(names), 2))
    keep = np.isin(names, MOVABLE_CLASSES) & (num_pts > 0)
    if not keep.any():
        return empty
    boxes, names, ids = boxes[keep], names[keep], ids[keep]
    num_pts, diff, speed = num_pts[keep], diff[keep], speed[keep]
    k = len(boxes)
    poses = np.tile(np.eye(4)[None], (k, 1, 1))
    yaw = boxes[:, 6]
    poses[:, 0, 0] = np.cos(yaw)
    poses[:, 0, 1] = -np.sin(yaw)
    poses[:, 1, 0] = np.sin(yaw)
    poses[:, 1, 1] = np.cos(yaw)
    # gt_boxes_lidar positions are in the VEHICLE frame -> lidar frame
    poses[:, :3, 3] = boxes[:, :3] + WAYMO_LIDAR_T_VEHICLE[:3, 3]
    return {
        "poses": poses,
        "size": boxes[:, 3:6],
        "track_ids": ids,
        "category": names,
        "velo": np.linalg.norm(speed.reshape(k, -1), axis=-1,
                               keepdims=True),
        "difficulty": diff[:, None],
        "num_pts": num_pts,
    }


def flow_from_objects(pcl_a, objs_a, objs_b, odom_a_b):
    """GT scene flow a->b (get_flow_waymo): rigid ego flow, overridden
    inside boxes whose track persists by the box-motion transform."""
    homog = np.concatenate(
        [pcl_a[:, :3].astype(np.float64), np.ones((len(pcl_a), 1))], -1
    )
    flow = (homog @ (np.linalg.inv(odom_a_b) - np.eye(4)).T)[:, :3]
    mask = np.full(len(pcl_a), np.iinfo(np.uint16).max, np.uint16)
    ids_b = list(objs_b["track_ids"])
    for k, tid in enumerate(objs_a["track_ids"]):
        local = homog @ np.linalg.inv(objs_a["poses"][k]).T
        in_box = (
            np.abs(local[:, :3]) < np.asarray(objs_a["size"][k]) / 2.0
        ).all(axis=-1)
        mask = np.where(in_box, np.uint16(k), mask)
        if tid in ids_b:
            kb = ids_b.index(tid)
            trafo = objs_b["poses"][kb] @ np.linalg.inv(objs_a["poses"][k])
            dyn = (homog @ (trafo - np.eye(4)).T)[:, :3]
            flow = np.where(in_box[:, None], dyn, flow)
    return flow.astype(np.float32), mask


def convert_sequence(
    processed_root: Path,
    seq_pkl: Path,
    target_dir: Path,
    icp_odometry=None,
    frame_stride: int = 1,
):
    with open(seq_pkl, "rb") as f:
        infos = pickle.load(f)
    if len(infos) < 3:
        return 0
    seq_name = seq_pkl.stem
    target_dir.mkdir(parents=True, exist_ok=True)

    cache = {}

    def get(i):
        if i not in cache:
            pcl = load_frame_pcl(processed_root, infos[i])
            cache[i] = (
                pcl,
                jpc_ground_remove(pcl[:, :3].astype(np.float64)),
                extract_objects(infos[i]),
            )
        return cache[i]

    kiss_poses = None
    if icp_odometry is not None:
        kiss_poses = icp_odometry(
            [load_frame_pcl(processed_root, fi)[:, :3].astype(np.float64)
             for fi in infos]
        )

    def w_T_lid(i):
        return np.asarray(infos[i]["pose"], np.float64) @ VEHICLE_T_WAYMO_LIDAR

    n = 0
    for i in range(0, len(infos) - 2, frame_stride):
        p0, g0, o0 = get(i)
        p1, g1, o1 = get(i + 1)
        p2, g2, o2 = get(i + 2)
        odom01 = np.linalg.inv(w_T_lid(i)) @ w_T_lid(i + 1)
        odom02 = np.linalg.inv(w_T_lid(i)) @ w_T_lid(i + 2)
        odom12 = np.linalg.inv(w_T_lid(i + 1)) @ w_T_lid(i + 2)
        fl01, m0 = flow_from_objects(p0, o0, o1, odom01)
        fl10, m1 = flow_from_objects(p1, o1, o0, np.linalg.inv(odom01))
        fl02, _ = flow_from_objects(p0, o0, o2, odom02)
        fl20, m2 = flow_from_objects(p2, o2, o0, np.linalg.inv(odom02))
        name = f"{seq_name}_{i:04d}"
        d = {
            "pcl_t0": p0, "pcl_t1": p1, "pcl_t2": p2,
            "is_ground_t0": g0, "is_ground_t1": g1, "is_ground_t2": g2,
            "flow_t0_t1": fl01, "flow_t1_t0": fl10,
            "flow_t0_t2": fl02, "flow_t2_t0": fl20,
            "track_ids_mask_t0": m0, "track_ids_mask_t1": m1,
            "track_ids_mask_t2": m2,
            "odom_t0_t1": odom01, "odom_t0_t2": odom02,
            "odom_t1_t2": odom12,
            "objects_t0": o0, "objects_t1": o1, "objects_t2": o2,
            "name": name,
        }
        for (a, ia), (b, ib) in (((0, i), (1, i + 1)), ((0, i), (2, i + 2)),
                                 ((1, i + 1), (2, i + 2))):
            if kiss_poses is not None:
                o = np.linalg.inv(kiss_poses[ia]) @ kiss_poses[ib]
            else:
                o = d[f"odom_t{a}_t{b}"]
            d[f"kiss_odom_t{a}_t{b}"] = o
            d[f"kiss_odom_t{b}_t{a}"] = np.linalg.inv(o)
        np.save(target_dir / name, d)
        cache.pop(i, None)
        n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--processed_root", required=True, type=Path,
                    help="OpenPCDet waymo_processed_data_v0_5_0 dir")
    ap.add_argument("--target_dir", required=True, type=Path)
    ap.add_argument("--use_icp", action="store_true")
    ap.add_argument("--frame_stride", type=int, default=1)
    ap.add_argument("--world_size", type=int, default=1)
    ap.add_argument("--worker_id", type=int, default=0)
    args = ap.parse_args(argv)
    icp = None
    if args.use_icp:
        from liso_tpu_torch.data.icp import icp_odometry

        icp = icp_odometry
    pkls = sorted(args.processed_root.rglob("*.pkl"))
    target = args.target_dir / "waymo"
    total = 0
    for i, pkl_path in enumerate(pkls):
        if i % args.world_size != args.worker_id:
            continue
        total += convert_sequence(
            args.processed_root, pkl_path, target, icp, args.frame_stride
        )
    print(f"wrote {total} samples to {target}")


if __name__ == "__main__":
    main()
