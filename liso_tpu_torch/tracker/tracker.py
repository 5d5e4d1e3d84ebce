"""Flow-based offline box tracker (host-side numpy).

Behavioral reference: liso/tracker/global_box_tracker.py:13-514 and
liso/tracker/tracking_helpers.py:30-45. The tracker consumes whole sequences
frame by frame (it sits between device-side inference and DB export, off the
hot path — SURVEY.md §5 "long-context"), so it stays sequential numpy:

  * odometry is integrated to world poses,
  * forward + backward greedy association against flow-propagated detections
    (each frame's detections are propagated into the neighbouring frame by
    the per-box Kabsch foreground motion; association threshold in meters),
  * unmatched live tracks coast for one frame with damped confidence,
  * track age = max(forward age, backward age),
  * single-frame holes are filled with the coasted forward box.

Boxes cross the host boundary as plain dict-of-numpy arrays (variable K per
frame — no padding needed on host).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from liso_tpu_torch.tracker.matching import greedy_match_by_confidence

BoxArr = Dict[str, np.ndarray]  # pos [K,3], dims [K,3], rot [K,1], probs [K,1], velo [K,1]

INITIAL_TRACK_CONF = 1.0
MIN_ALIVE_TRACK_CONF = 0.0
MAX_PROPAGATION_TIME = 1


def empty_boxes() -> BoxArr:
    return {
        "pos": np.zeros((0, 3), np.float32),
        "dims": np.zeros((0, 3), np.float32),
        "rot": np.zeros((0, 1), np.float32),
        "probs": np.zeros((0, 1), np.float32),
        "velo": np.zeros((0, 1), np.float32),
    }


def cat_boxes(a: BoxArr, b: BoxArr) -> BoxArr:
    return {k: np.concatenate([a[k], b[k]], axis=0) for k in a}


def take_boxes(a: BoxArr, idx) -> BoxArr:
    return {k: v[idx] for k, v in a.items()}


def num_boxes(a: BoxArr) -> int:
    return len(a["pos"])


def box_poses(a: BoxArr) -> np.ndarray:
    """[K, 4, 4] sensor_T_box."""
    k = num_boxes(a)
    T = np.tile(np.eye(4, dtype=np.float64)[None], (k, 1, 1))
    yaw = a["rot"][:, 0]
    c, s = np.cos(yaw), np.sin(yaw)
    T[:, 0, 0], T[:, 0, 1] = c, -s
    T[:, 1, 0], T[:, 1, 1] = s, c
    T[:, :3, 3] = a["pos"]
    return T


def transform_boxes(a: BoxArr, T: np.ndarray) -> BoxArr:
    """Apply [4, 4] T to all boxes."""
    poses = T[None] @ box_poses(a)
    out = dict(a)
    out["pos"] = poses[:, :3, 3].astype(np.float32)
    out["rot"] = np.arctan2(poses[:, 1, 0], poses[:, 0, 0]).astype(np.float32)[
        :, None
    ]
    return out


def aggregate_world_poses(odoms: List[np.ndarray]) -> List[np.ndarray]:
    """tracking_helpers.aggregate_odometry_to_world_poses: w_T_s(0)=I then
    chain sti_T_stii."""
    w = [np.eye(4, dtype=np.float64)]
    for o in odoms:
        w.append(w[-1] @ np.asarray(o, np.float64))
    return w


class FlowBasedBoxTracker:
    def __init__(self, box_matching_threshold_m: float = 1.0):
        self.thresh = box_matching_threshold_m
        self.boxes_sensor: List[BoxArr] = []
        self.prop_poses_past: List[np.ndarray] = []  # s(t-1)_T_box per det
        self.prop_poses_future: List[np.ndarray] = []  # s(t+1)_T_box per det
        self.odoms: List[np.ndarray] = []
        self.extra: List[list] = []

    def update(
        self,
        boxes: BoxArr,
        propagated_box_poses_future: Optional[np.ndarray],
        propagated_box_poses_past: Optional[np.ndarray],
        odom_t_tnext: np.ndarray,
        per_box_extra: Optional[list] = None,
    ):
        k = num_boxes(boxes)
        self.boxes_sensor.append({k_: np.asarray(v) for k_, v in boxes.items()})
        own = box_poses(boxes)
        self.prop_poses_past.append(
            np.asarray(propagated_box_poses_past, np.float64)
            if propagated_box_poses_past is not None
            else own
        )
        self.prop_poses_future.append(
            np.asarray(propagated_box_poses_future, np.float64)
            if propagated_box_poses_future is not None
            else own
        )
        self.odoms.append(np.asarray(odom_t_tnext, np.float64))
        self.extra.append(
            list(per_box_extra) if per_box_extra is not None else [None] * k
        )

    # ------------------------------------------------------------------
    def _track_one_way(
        self,
        boxes_world: List[BoxArr],
        prop_into_prev_world: List[np.ndarray],
        start_id: int,
    ):
        """global_box_tracker.track_one_way. Returns (boxes incl. coasted,
        track_ids per frame, max_id). Frame t's detections (propagated into
        t-1's frame) are matched against frame t-1's live track boxes."""
        n_t = len(boxes_world)
        ids: List[np.ndarray] = []
        ages: List[np.ndarray] = []
        confs: List[np.ndarray] = []
        out_boxes = [dict(b) for b in boxes_world]

        k0 = num_boxes(out_boxes[0])
        ids.append(start_id + 1 + np.arange(k0, dtype=np.int64))
        ages.append(np.zeros(k0, np.int64))
        confs.append(np.full(k0, INITIAL_TRACK_CONF, np.float32))
        max_id = start_id + k0

        for t in range(1, n_t):
            prev_boxes = out_boxes[t - 1]
            prev_ids, prev_ages, prev_confs = ids[-1], ages[-1], confs[-1]
            alive = prev_confs >= MIN_ALIVE_TRACK_CONF

            # constant-velocity propagation of prev boxes that matched in t-2
            prop_prev = {k: v.copy() for k, v in prev_boxes.items()}
            if t >= 2:
                pp_ids = ids[-2]
                match = prev_ids[:, None] == pp_ids[None, :]
                has = match.any(-1)
                if has.any():
                    pp_idx = np.argmax(match, axis=-1)[has]
                    prop_prev["pos"][has] += (
                        prop_prev["pos"][has] - out_boxes[t - 2]["pos"][pp_idx]
                    )

            cur = out_boxes[t]
            k_cur = num_boxes(cur)
            pred_prev_pos = prop_into_prev_world[t][:, :3, 3].astype(np.float32)

            m = greedy_match_by_confidence(
                pred_prev_pos,  # "gt": current dets propagated into t-1
                prev_boxes["pos"][alive],
                prev_confs[alive],
                self.thresh,
                match_in_nd=2,
            )
            # NOTE reference passes (gt=propagated currents, pred=alive prevs)
            # so idxs_gt indexes currents and idxs_pred indexes alive prevs
            idxs_cur, idxs_alive_prev = m.idxs_gt, m.idxs_pred
            matched_cur = m.matched_gts_mask
            matched_prev_alive = m.matched_preds_mask

            cur_ids = -np.ones(k_cur, np.int64)
            cur_ids[idxs_cur] = prev_ids[alive][idxs_alive_prev]
            n_new = int((~matched_cur).sum())
            cur_ids[~matched_cur] = max_id + 1 + np.arange(n_new)
            if n_new:
                max_id = int(cur_ids.max())
            cur_ages = np.zeros(k_cur, np.int64)
            cur_ages[idxs_cur] = 1 + prev_ages[alive][idxs_alive_prev]
            cur_confs = np.full(k_cur, INITIAL_TRACK_CONF, np.float32)

            # coast unmatched live tracks one frame with damped confidence
            coast = alive.copy()
            coast[alive] &= ~matched_prev_alive
            coast_boxes = take_boxes(prop_prev, coast)
            coast_conf = (
                1e-4
                + prev_confs[coast]
                - INITIAL_TRACK_CONF / MAX_PROPAGATION_TIME
            )
            out_boxes[t] = cat_boxes(cur, coast_boxes)
            ids.append(np.concatenate([cur_ids, prev_ids[coast]]))
            ages.append(np.concatenate([cur_ages, prev_ages[coast]]))
            confs.append(np.concatenate([cur_confs, coast_conf]))
        return out_boxes, ids, max_id

    # ------------------------------------------------------------------
    def run_tracker(self):
        n_t = len(self.boxes_sensor)
        if n_t == 0:  # watchdog may abort before any frame
            self.w_Ts = []
            self.boxes_world = []
            self.track_ids = []
            self.track_ages = []
            self.extra_out = []
            return
        self.w_Ts = aggregate_world_poses(self.odoms)[:n_t]
        boxes_world = [
            transform_boxes(b, w) for b, w in zip(self.boxes_sensor, self.w_Ts)
        ]
        self.boxes_world = [dict(b) for b in boxes_world]

        prop_past_world = []
        prop_future_world = []
        for t in range(n_t):
            w_prev = self.w_Ts[max(t - 1, 0)]
            prop_past_world.append(w_prev[None] @ self.prop_poses_past[t])
            w_next = self.w_Ts[min(t + 1, n_t - 1)]
            prop_future_world.append(w_next[None] @ self.prop_poses_future[t])

        fwd_boxes, fwd_ids, max_id = self._track_one_way(
            [dict(b) for b in boxes_world], prop_past_world, 0
        )
        bwd_boxes, bwd_ids, _ = self._track_one_way(
            [dict(b) for b in boxes_world[::-1]], prop_future_world[::-1], max_id
        )
        bwd_ids = bwd_ids[::-1]

        def age_lookup(all_ids):
            flat = np.concatenate(all_ids) if all_ids else np.zeros(0, np.int64)
            u, c = np.unique(flat, return_counts=True)
            return dict(zip(u.tolist(), c.tolist()))

        fwd_age = age_lookup(fwd_ids)
        bwd_age = age_lookup(bwd_ids)

        self.track_ids: List[np.ndarray] = []
        self.track_ages: List[np.ndarray] = []
        self.extra_out: List[list] = []
        for t in range(n_t):
            k = num_boxes(self.boxes_world[t])
            tid = fwd_ids[t][:k]
            age_f = np.array([fwd_age.get(int(i), 0) for i in tid], np.int64)
            age_b = np.array(
                [bwd_age.get(int(i), 0) for i in bwd_ids[t][:k]], np.int64
            )
            self.track_ids.append(tid)
            self.track_ages.append(np.maximum(age_f, age_b))
            self.extra_out.append(list(self.extra[t][:k]))

        # hole filling with coasted forward boxes
        # (global_box_tracker.py:198-241)
        all_ids = (
            np.unique(np.concatenate(self.track_ids))
            if any(len(i) for i in self.track_ids)
            else np.zeros(0, np.int64)
        )
        for tid in all_ids:
            occurs = [bool((ids == tid).any()) for ids in self.track_ids]
            if not any(occurs):
                continue
            first, last = occurs.index(True), len(occurs) - occurs[::-1].index(True) - 1
            for t in range(first + 1, last):
                if occurs[t]:
                    continue
                src = np.where(fwd_ids[t] == tid)[0]
                if len(src) == 0:
                    continue
                fill = take_boxes(fwd_boxes[t], src)
                age = max(fwd_age.get(int(tid), 0), bwd_age.get(int(tid), 0))
                self.boxes_world[t] = cat_boxes(self.boxes_world[t], fill)
                self.track_ids[t] = np.concatenate(
                    [self.track_ids[t], np.full(len(src), tid, np.int64)]
                )
                self.track_ages[t] = np.concatenate(
                    [self.track_ages[t], np.full(len(src), age, np.int64)]
                )
                self.extra_out[t].extend([None] * len(src))

    # ------------------------------------------------------------------
    def get_boxes_in_sensor_coordinates(self) -> List[BoxArr]:
        return [
            transform_boxes(b, np.linalg.inv(w))
            for b, w in zip(self.boxes_world, self.w_Ts)
        ]

    def get_track_ids_and_ages(self):
        return self.track_ids, self.track_ages


class NotATracker:
    """Pass-through tracker (liso/tracker/box_tracker.py:8-126): every
    detection is its own age-inf track — lets the mining path run without
    association for ablations."""

    def __init__(self, **_):
        self.frames: List[BoxArr] = []
        self.odoms: List[np.ndarray] = []
        self.extra: List[list] = []
        self._next_id = 0

    def update(self, boxes: BoxArr, _f=None, _p=None, odom=None, per_box_extra=None):
        self.frames.append({k: np.asarray(v) for k, v in boxes.items()})
        self.odoms.append(
            np.asarray(odom, np.float64) if odom is not None else np.eye(4)
        )
        self.extra.append(
            list(per_box_extra)
            if per_box_extra is not None
            else [None] * num_boxes(boxes)
        )

    def run_tracker(self):
        self.w_Ts = aggregate_world_poses(self.odoms)[: len(self.frames)]
        self.boxes_world = [
            transform_boxes(b, w) for b, w in zip(self.frames, self.w_Ts)
        ]
        self.track_ids = []
        self.track_ages = []
        self.extra_out = self.extra
        for b in self.frames:
            k = num_boxes(b)
            self.track_ids.append(self._next_id + np.arange(k, dtype=np.int64))
            self._next_id += k
            self.track_ages.append(np.full(k, 10**6, np.int64))

    def get_boxes_in_sensor_coordinates(self):
        return self.frames

    def get_track_ids_and_ages(self):
        return self.track_ids, self.track_ages
