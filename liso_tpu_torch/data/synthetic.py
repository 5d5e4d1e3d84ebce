"""Synthetic LiDAR sequences — first-class test/dev dataset (port of
liso_tpu/data/synthetic.py).

The reference has no such fixture (its `--fast-test` smoke needs real data
on disk); here synthetic drives with a ground plane, static structures and
moving box objects generate the exact npy sample-dict format of the real
ETL (datasets/kitti/create_kitti_raw.py:119-175), so every pipeline stage —
SLIM training, mining, detector training, eval — runs hermetically.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from liso_tpu_torch.data.dataset import DataCfg, LidarDataset


def _scene_points(rng, n_bg: int, extent: float):
    ground = rng.uniform(-extent, extent, (n_bg // 2, 3)).astype(np.float32)
    ground[:, 2] = rng.uniform(-1.9, -1.6, len(ground))
    walls = rng.uniform(-extent, extent, (n_bg - len(ground), 3)).astype(np.float32)
    walls[:, 2] = rng.uniform(-1.5, 0.8, len(walls))
    return ground, walls


def _box_points(rng, n: int, dims):
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32) * (
        0.5 * np.asarray(dims, np.float32)
    )
    return pts


class SyntheticSequence:
    """One drive: ego moving at `ego_speed`, `n_objects` boxes with
    constant velocities."""

    def __init__(
        self,
        seq_id: str = "synth0",
        n_frames: int = 12,
        n_bg: int = 6000,
        n_obj_pts: int = 400,
        n_objects: int = 2,
        ego_speed: float = 0.5,  # m/frame
        seed: int = 0,
        bounce_bound: float | None = None,
    ):
        """bounce_bound: with a float, objects reflect off the |x|,|y| <=
        bound walls (world frame) so long drives keep every object inside
        the BEV range — the path/yaw become piecewise-linear and the GT
        flow is derived from the actual per-frame poses, staying exact
        across bounces. None (default) keeps the original closed-form
        constant-velocity motion bit-for-bit."""
        self.seq_id = seq_id
        self.n_frames = n_frames
        rng = np.random.RandomState(seed)
        self.ground, self.walls = _scene_points(rng, n_bg, 30.0)
        self.objects = []
        for i in range(n_objects):
            dims = np.array([4.0, 2.0, 1.6], np.float32)
            start = rng.uniform(-12, 6, 2)
            vel = rng.uniform(0.8, 2.0) * np.array(
                [np.cos(a := rng.uniform(-np.pi, np.pi)), np.sin(a)]
            )
            self.objects.append(
                {
                    "dims": dims,
                    "start": np.array([start[0], start[1], -1.0], np.float32),
                    "vel_w": np.array([vel[0], vel[1], 0.0], np.float32),
                    "pts": _box_points(rng, n_obj_pts, dims),
                    "yaw": float(np.arctan2(vel[1], vel[0])),
                }
            )
        self.ego_speed = ego_speed
        self.bounce_bound = bounce_bound
        if bounce_bound is not None:
            # simulate piecewise-linear bouncing paths for every frame the
            # sample dicts can touch (t0..t2 pairs + one velocity lookahead)
            T = n_frames + 4
            for o in self.objects:
                centers = np.empty((T, 3), np.float64)
                vels = np.empty((T, 3), np.float64)
                pos = o["start"].astype(np.float64).copy()
                vel = o["vel_w"].astype(np.float64).copy()
                for t in range(T):
                    centers[t] = pos
                    for ax in range(2):
                        nxt = pos[ax] + vel[ax]
                        if abs(nxt) > bounce_bound:
                            vel[ax] = -vel[ax]
                    vels[t] = vel
                    pos = pos + vel
                o["centers"] = centers.astype(np.float32)
                o["vels"] = vels.astype(np.float32)
                o["yaws"] = np.arctan2(
                    vels[:, 1], vels[:, 0]
                ).astype(np.float32)

    def _obj_pose(self, o, t: int):
        """(center [3], yaw) of object o at frame t."""
        if self.bounce_bound is None:
            return o["start"] + o["vel_w"] * t, o["yaw"]
        return o["centers"][t], float(o["yaws"][t])

    def world_T_sensor(self, t: int) -> np.ndarray:
        T = np.eye(4)
        T[0, 3] = self.ego_speed * t
        return T

    def frame_world(self, t: int):
        """(points world [N,4], per-point flow world [N,3], boxes world)."""
        pts = [self.ground, self.walls]
        flow = [np.zeros((len(self.ground), 3)), np.zeros((len(self.walls), 3))]
        boxes = []
        for o in self.objects:
            center, yaw = self._obj_pose(o, t)
            c, s = np.cos(yaw), np.sin(yaw)
            R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            p = o["pts"] @ R.T + center
            pts.append(p)
            if self.bounce_bound is None:
                flow.append(np.tile(o["vel_w"][None], (len(p), 1)))
                speed = float(np.linalg.norm(o["vel_w"]))
            else:
                cn, yn = self._obj_pose(o, t + 1)
                c2, s2 = np.cos(yn), np.sin(yn)
                Rn = np.array(
                    [[c2, -s2, 0], [s2, c2, 0], [0, 0, 1]], np.float32
                )
                flow.append(o["pts"] @ Rn.T + cn - p)
                speed = float(np.linalg.norm(np.asarray(cn) - center))
            boxes.append(
                {
                    "pos": np.asarray(center, np.float32),
                    "dims": o["dims"],
                    "rot": np.array([yaw], np.float32),
                    "probs": np.ones(1, np.float32),
                    "velo": np.array([speed], np.float32),
                }
            )
        p = np.concatenate(pts).astype(np.float32)
        inten = np.linspace(0, 1, len(p), dtype=np.float32)[:, None]
        return (
            np.concatenate([p, inten], -1),
            np.concatenate(flow).astype(np.float32),
            boxes,
        )

    def _world_targets(self, t: int, dt: int):
        """World positions at t+dt of the points sampled at frame t (static
        scene stays put; object points track their box pose — exact across
        bounces)."""
        tg = [self.ground[:, :3], self.walls[:, :3]]
        for o in self.objects:
            c, yaw = self._obj_pose(o, t + dt)
            cs, sn = np.cos(yaw), np.sin(yaw)
            R = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]], np.float32)
            tg.append(o["pts"] @ R.T + c)
        return np.concatenate(tg).astype(np.float32)

    def sample_dict(self, t: int) -> dict:
        """Reference ETL npy format for the pair/triple (t, t+1, t+2)."""
        content = {"name": f"{self.seq_id}_{t:04d}"}
        w_T_s = {dt: self.world_T_sensor(t + dt) for dt in range(3)}
        gt = {}
        for dt, tk in enumerate(("t0", "t1", "t2")):
            pts_w, flow_w, boxes_w = self.frame_world(t + dt)
            s_T_w = np.linalg.inv(w_T_s[dt])
            p = pts_w.copy()
            p[:, :3] = pts_w[:, :3] @ s_T_w[:3, :3].T + s_T_w[:3, 3]
            content[f"pcl_{tk}"] = p.astype(np.float32)
            content[f"lidar_rows_{tk}"] = (
                np.arange(len(p)) % 64
            ).astype(np.int32)
            gt[f"is_ground_{tk}"] = p[:, 2] < -1.55
            content[f"is_ground_{tk}"] = gt[f"is_ground_{tk}"]
            if dt == 0:
                boxes_s = []
                for b in boxes_w:
                    pos = s_T_w[:3, :3] @ b["pos"] + s_T_w[:3, 3]
                    boxes_s.append({**b, "pos": pos.astype(np.float32)})
                gt["boxes"] = (
                    {
                        k: np.stack([b[k] for b in boxes_s])
                        for k in boxes_s[0]
                    }
                    if boxes_s
                    else {
                        "pos": np.zeros((0, 3), np.float32),
                        "dims": np.zeros((0, 3), np.float32),
                        "rot": np.zeros((0, 1), np.float32),
                        "probs": np.zeros((0, 1), np.float32),
                        "velo": np.zeros((0, 1), np.float32),
                    }
                )
        # GT flow convention (reference): p_t0 + flow lands in the TARGET
        # frame's sensor coords — flow includes ego motion
        # (head_decoder.py:124-155 gt_static_flow = (t1_T_t0 - I) p)
        pts_w0, flow_w0, _ = self.frame_world(t)
        s0_T_w = np.linalg.inv(w_T_s[0])
        p0_s = pts_w0[:, :3] @ s0_T_w[:3, :3].T + s0_T_w[:3, 3]
        for dt, key in ((1, "flow_t0_t1"), (2, "flow_t0_t2")):
            if self.bounce_bound is None:
                tgt_w = pts_w0[:, :3] + flow_w0 * dt
            else:
                tgt_w = self._world_targets(t, dt)
            sdt_T_w = np.linalg.inv(w_T_s[dt])
            tgt_s = tgt_w @ sdt_T_w[:3, :3].T + sdt_T_w[:3, 3]
            gt[key] = (tgt_s - p0_s).astype(np.float32)
        # reverse flow for the t1 cloud: target expressed in sensor-t0 coords
        pts_w1, flow_w1, _ = self.frame_world(t + 1)
        s1_T_w = np.linalg.inv(w_T_s[1])
        p1_s = pts_w1[:, :3] @ s1_T_w[:3, :3].T + s1_T_w[:3, 3]
        if self.bounce_bound is None:
            back_w = pts_w1[:, :3] - flow_w1
        else:
            back_w = self._world_targets(t + 1, -1)
        tgt_s = back_w @ s0_T_w[:3, :3].T + s0_T_w[:3, 3]
        gt["flow_t1_t0"] = (tgt_s - p1_s).astype(np.float32)

        for dt_a, dt_b in ((0, 1), (0, 2), (1, 2)):
            odom = np.linalg.inv(w_T_s[dt_a]) @ w_T_s[dt_b]
            content[f"odom_t{dt_a}_t{dt_b}"] = odom.astype(np.float64)
            content[f"kiss_odom_t{dt_a}_t{dt_b}"] = odom.astype(np.float64)
        content["gt"] = gt
        return content


class SyntheticDataset(LidarDataset):
    def __init__(self, cfg: DataCfg, n_frames: int = 12, seed: int = 0,
                 augmentation=None, n_points: int = 6000,
                 cache_content: bool = False, n_objects: int = 2,
                 ego_speed: float = 0.5, n_obj_pts: int = 400,
                 bounce_bound: float | None = None, **kw):
        # cache_content memoizes the generated sample dicts so throughput
        # benchmarks measure the PIPELINE (crop/ground/pad/collate), not the
        # synthetic generator — real datasets load these dicts from npz.
        # Off by default: at 65k points a cached triple is ~3 MB/frame.
        self.seq = SyntheticSequence(
            n_frames=n_frames + 2, seed=seed, n_bg=n_points,
            n_objects=n_objects, ego_speed=ego_speed, n_obj_pts=n_obj_pts,
            bounce_bound=bounce_bound,
        )
        self._content_cache = {} if cache_content else None
        super().__init__(
            cfg,
            sample_files=[Path(f"synth0_{t:04d}.npy") for t in range(n_frames)],
            augmentation=augmentation,
            **kw,
        )

    def load_sample_dict(self, idx: int) -> dict:
        if self._content_cache is not None:
            if idx not in self._content_cache:
                self._content_cache[idx] = self.seq.sample_dict(idx)
            return self._content_cache[idx]
        return self.seq.sample_dict(idx)

    def extract_gt_boxes(self, content: dict, time_key: str):
        if time_key != "t0":
            return None  # boxes only annotated at t0 (reference convention)
        return {
            k: np.asarray(v, np.float32)
            for k, v in content["gt"]["boxes"].items()
        }

    def get_consecutive_sample_idxs_for_sequence(self, seq_of_idx: int = 0):
        return list(range(len(self)))

    def _gt_flow(self, content, a, b, pcl, keep):
        key = f"flow_{a}_{b}"
        if key in content["gt"]:
            return np.asarray(content["gt"][key], np.float32)[keep]
        return super()._gt_flow(content, a, b, pcl, keep)
