"""Offline ETL: KITTI object (detection benchmark) -> per-sample npy dicts.

Behavioral reference: liso/datasets/kitti/create_kitti_object.py:1-240.
Output schema identical: pcl_t0 (f32 [N,4]), is_ground_t0, objects_t0
{poses [K,4,4] velo frame, size [K,3] lwh, category}, optional pcl_t1/
is_ground_t1 (the NEXT raw frame located through the devkit mapping files),
img_T_lidar, name "{split}_XXXXXX". Split layout mirrors the reference:
kitti_object_w_future_pcl/{train,val,test}/.

Devkit-free differences: the mmdet3d KittiDataset + kitti_data_prep info
pickles are replaced by direct parsing of label_2/calib txt files and the
ImageSets split lists; the raw-frame lookup uses the same
devkit_object/mapping/{train_rand,train_mapping}.txt files the reference
reads (create_kitti_object.get_kitti_filenames_for_sample:19-72).

Usage:
  python -m liso_tpu_torch.data.create_kitti_object \
      --kitti_object_root .../kitti_object --kitti_raw_root .../raw \
      --target_dir T
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np

from liso_tpu_torch.data.create_kitti import load_velo
from liso_tpu_torch.data.create_kitti_tracking import cam_T_obj_from_label
from liso_tpu_torch.data.ground import jpc_ground_remove


def read_object_calib(path: Path):
    vals = {}
    for line in path.read_text().splitlines():
        if ":" not in line:
            continue
        key, _, rest = line.partition(":")
        vals[key.strip()] = np.fromstring(rest, sep=" ")
    r_rect = np.eye(4)
    r_rect[:3, :3] = vals["R0_rect"].reshape(3, 3)
    tr = np.eye(4)
    tr[:3, :4] = vals["Tr_velo_to_cam"].reshape(3, 4)
    cam_T_velo = r_rect @ tr
    p2 = vals["P2"].reshape(3, 4)
    img_T_lidar = np.eye(4)
    img_T_lidar[:3] = p2 @ cam_T_velo
    return {
        "velo_T_cam": np.linalg.inv(cam_T_velo),
        "img_T_lidar": img_T_lidar,
    }


def parse_object_labels(path: Path):
    """label_2/XXXXXX.txt (KITTI object format: type trunc occl alpha
    bbox(4) h w l x y z ry) -> list of dicts; DontCare kept out (the
    reference's mmdet3d info pipeline drops them from gt_bboxes_3d)."""
    objs = []
    if not path.exists():
        return objs
    for line in path.read_text().splitlines():
        f = line.split()
        if len(f) < 15 or f[0] == "DontCare":
            continue
        h, w, l = float(f[8]), float(f[9]), float(f[10])
        x, y, z = float(f[11]), float(f[12]), float(f[13])
        objs.append(
            dict(category=f[0], dims_lwh=(l, w, h), loc_cam=(x, y, z),
                 rot_y=float(f[14]))
        )
    return objs


def load_mapping(kitti_object_root: Path):
    mdir = kitti_object_root / "devkit_object" / "mapping"
    try:
        rand = [
            int(x)
            for x in (mdir / "train_rand.txt").read_text().strip().split(",")
        ]
        mapping = (mdir / "train_mapping.txt").read_text().strip().split("\n")
        return rand, mapping
    except FileNotFoundError:
        return None, None


def next_raw_pcl(
    sample_idx: int, rand, mapping, kitti_raw_root: Path
) -> Optional[Path]:
    """The raw .bin one frame AFTER the object sample
    (get_kitti_filenames_for_sample with hist_size=2, into_past=False)."""
    if rand is None:
        return None
    map_id = rand[sample_idx] - 1  # 1-based ids in the file
    date, drive, frame = mapping[map_id].split(" ")
    nxt = int(frame) + 1
    p = (
        kitti_raw_root / date / drive / "velodyne_points" / "data"
        / f"{str(nxt).zfill(len(frame))}.bin"
    )
    cur = p.with_name(f"{frame.strip().zfill(len(frame))}.bin")
    if not p.exists() or not cur.exists():
        return None
    return p


def read_split_ids(kitti_object_root: Path, split: str):
    f = kitti_object_root / "ImageSets" / f"{split}.txt"
    if f.exists():
        return [int(x) for x in f.read_text().split()]
    return None


def convert_split(
    kitti_object_root: Path,
    kitti_raw_root: Optional[Path],
    target_base: Path,
    split: str,
):
    is_test = split == "test"
    sub = "testing" if is_test else "training"
    velo_dir = kitti_object_root / sub / "velodyne"
    ids = read_split_ids(kitti_object_root, split)
    if ids is None:
        ids = sorted(int(f.stem) for f in velo_dir.glob("*.bin"))
    rand, mapping = (None, None) if is_test else load_mapping(
        kitti_object_root
    )
    target_dir = target_base / split
    target_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for sid in ids:
        stem = str(sid).zfill(6)
        velo = velo_dir / f"{stem}.bin"
        if not velo.exists():
            continue
        pcl = load_velo(velo)
        calib = read_object_calib(
            kitti_object_root / sub / "calib" / f"{stem}.txt"
        )
        d = {
            "pcl_t0": pcl.astype(np.float32),
            "is_ground_t0": jpc_ground_remove(pcl[:, :3]),
            "name": f"{split}_{stem}",
            "img_T_lidar": calib["img_T_lidar"].astype(np.float64),
        }
        if not is_test:
            objs = parse_object_labels(
                kitti_object_root / sub / "label_2" / f"{stem}.txt"
            )
            poses = (
                np.stack(
                    [calib["velo_T_cam"] @ cam_T_obj_from_label(o)
                     for o in objs]
                )
                if objs
                else np.zeros((0, 4, 4), np.float64)
            )
            d["objects_t0"] = {
                "poses": poses,
                "size": np.asarray(
                    [o["dims_lwh"] for o in objs], np.float64
                ).reshape(-1, 3),
                "category": np.asarray([o["category"] for o in objs]),
            }
            if kitti_raw_root is not None:
                nxt = next_raw_pcl(sid, rand, mapping, kitti_raw_root)
                if nxt is not None:
                    p1 = load_velo(nxt)
                    d["pcl_t1"] = p1.astype(np.float32)
                    d["is_ground_t1"] = jpc_ground_remove(p1[:, :3])
        np.save(target_dir / d["name"], d)
        n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kitti_object_root", required=True, type=Path)
    ap.add_argument("--kitti_raw_root", default=None, type=Path)
    ap.add_argument("--target_dir", required=True, type=Path)
    args = ap.parse_args(argv)
    target = args.target_dir / "kitti_object_w_future_pcl"
    total = 0
    for split in ("train", "val", "test"):
        total += convert_split(
            args.kitti_object_root, args.kitti_raw_root, target, split
        )
    print(f"wrote {total} samples to {target}")


if __name__ == "__main__":
    main()
