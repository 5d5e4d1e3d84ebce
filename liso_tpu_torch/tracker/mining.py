"""Sequence mining, the heart of the LISO self-training loop (port of
liso_tpu/tracker/mining.py).

Behavioral reference: liso/tracker/tracking.py:503-1924
(track_boxes_on_data_sequence). Per frame: detect (device), the BEV-border
and min-points filters and the flow propagation into the neighbour frames
as one device program whose outputs reach the host in one copy, then the
tracker update (host). Per sequence: the two-pass tracker, tracks kept by
age >= min_track_age and median confidence, the speed / travel filters,
local box refinement (quantile dims + closeness-to-edge fits on the
device), trajectory smoothing (Adam on the jerk, on the device), then the
per-sample mined-box DB and the box-points augmentation DB.

Association, the track filters and the DB assembly are variable-length host
numpy, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.tracker.dbs import empty_augm_db
from liso_tpu_torch.tracker.propagation import (
    propagate_boxes_with_flow,
    soft_align_yaw_with_motion,
)
from liso_tpu_torch.tracker.refinement import (
    decide_keep_or_drop_track,
    refine_track_boxes,
)
from liso_tpu_torch.tracker.smoothing import (
    smooth_track_bike_model,
    MIN_TRACK_LEN_FOR_SMOOTHING,
    smooth_track_jerk,
)
from liso_tpu_torch.tracker.tracker import (
    BoxArr,
    FlowBasedBoxTracker,
    box_poses,
    transform_boxes,
)


class MiningCfg(NamedTuple):
    min_track_age: int = 4
    track_confidence_threshold: float = 0.3
    min_points_in_box: int = 20
    box_matching_threshold_m: float = 1.0
    min_track_obj_speed_mps: float = 0.0
    flow_cluster_min_travel_dist_m: float = 0.5
    time_between_frames_s: float = 0.1
    is_flow_cluster_detector: bool = True
    align_yaw_with_motion: bool = False  # True for trained detectors
    dims_quantile: float = 0.95  # 0.6 for trained detectors
    fit_rot: bool = True
    fit_pos: bool = True
    smoothing_iters: int = 2000
    track_smoothing_method: str = "jerk"  # or "bike_model"
    vehicle_length_fallback_m: float = 4.0
    snippet_bloat: float = 1.1
    drop_boxes_on_bev_border: bool = True
    timeout_s: float = 0.0  # watchdog: stop ingesting frames after this
    # (reference tracking.py:533-557 aborts sequence iteration gracefully)


class Frame(NamedTuple):
    """One mining sample (host numpy). pcl = no-ground BEV-cropped cloud."""

    sample_id: str
    pcl: np.ndarray  # [N, >=4]
    valid: np.ndarray  # [N]
    flow: np.ndarray  # [N, 3] ta->tb
    odom_ta_tb: np.ndarray  # [4, 4]
    lidar_rows: Optional[np.ndarray] = None  # [N] sensor row index


def _mine_frame_device(boxes: Boxes, pcl, valid, flow, odom, odom_inv,
                       bev: BevSetup, min_points: int, drop_border: bool,
                       align_yaw: bool):
    """All per-frame device work: the BEV-border and min-points filters,
    forward and backward flow propagation, optional yaw alignment. Returns
    (boxes, st1_T_b [K, 4, 4], stm1_T_b [K, 4, 4]) on the device."""
    if drop_border:
        boxes = boxes.replace(valid=boxes.valid & boxes_in_bev_mask(boxes, bev))
    if min_points > 0:
        inside = boxes.points_in_box_mask(pcl[..., :3]) & valid[..., None]
        boxes = boxes.replace(valid=boxes.valid & (inside.sum(0) >= min_points))
    fg, bg_trafo, st1_T_b = propagate_boxes_with_flow(boxes, pcl, valid, flow,
                                                      odom)
    _, _, stm1_T_b = propagate_boxes_with_flow(boxes, pcl, valid, -flow,
                                               odom_inv)
    if align_yaw:
        boxes = soft_align_yaw_with_motion(boxes, fg, bg_trafo)
    return boxes, st1_T_b, stm1_T_b


_BOX_FIELDS = (("pos", 3), ("dims", 3), ("rot", 1), ("probs", 1), ("velo", 1))


def _frame_to_host(boxes: Boxes, st1_T_b, stm1_T_b):
    """The frame program's outputs in ONE device-to-host copy: (valid [K],
    the valid boxes as a BoxArr, st1_T_b [K, 4, 4], stm1_T_b [K, 4, 4]),
    fp32 as computed."""
    k = boxes.k
    velo = boxes.velo if boxes.velo is not None else torch.zeros_like(boxes.probs)
    packed = torch.cat([
        boxes.pos, boxes.dims, boxes.rot, boxes.probs, velo,
        boxes.valid.to(torch.float32)[:, None],
        st1_T_b.reshape(k, 16), stm1_T_b.reshape(k, 16),
    ], dim=-1).cpu().numpy()
    v = packed[:, 9] > 0.5
    det, o = {}, 0
    for name, c in _BOX_FIELDS:
        det[name] = np.ascontiguousarray(packed[v, o:o + c])
        o += c
    return (v, det, packed[:, 10:26].reshape(k, 4, 4),
            packed[:, 26:42].reshape(k, 4, 4))


def boxes_in_bev_mask(boxes: Boxes, bev: BevSetup) -> torch.Tensor:
    """tracking.py:747-767 drop_boxes_on_bev_boundaries: all BEV footprint
    corners must be inside the range."""
    corners = boxes.bev_corners()  # [K, 4, 2]
    half = torch.tensor([bev.bev_range_m[0] * 0.5, bev.bev_range_m[1] * 0.5],
                        dtype=corners.dtype, device=corners.device)
    return torch.all((corners.abs() < half).flatten(-2), dim=-1)


def union_proposals(
    primary: Boxes, secondary: Boxes, dedup_dist_m: float
) -> Boxes:
    """Per-frame mining-proposal union: concat `primary` (trained-detector)
    with `secondary` (flow-cluster) boxes, dropping secondary boxes whose
    BEV center lies within `dedup_dist_m` of any valid primary box.

    Rationale: after round 0 the reference mines ONLY from the trained
    detector (tracking.py:532-560 picks the network's own predictions), so
    any object the detector drops below threshold once can never re-enter
    the mined DB — the per-round recall can only ratchet downward on small
    drives. Unioning the always-available flow-cluster proposals back in
    keeps mining recall bounded below by the bootstrap's; the tracker's
    age/confidence/motion filters downstream still gate what is actually
    mined, so precision is unaffected. Enabled by
    optimization.rounds.mine_proposal_union (off by default =
    reference-parity behavior)."""
    p = primary.with_defaults()
    s = secondary.with_defaults()
    d2 = ((s.pos[:, None, :2] - p.pos[None, :, :2]) ** 2).sum(-1)
    close = (d2 < dedup_dist_m * dedup_dist_m) & p.valid[None, :]
    s_valid = s.valid & ~close.any(dim=1)
    cat = lambda a, b: torch.cat([a, b], dim=0)
    return Boxes(
        pos=cat(p.pos, s.pos),
        dims=cat(p.dims, s.dims),
        rot=cat(p.rot, s.rot),
        probs=cat(p.probs, s.probs),
        velo=cat(p.velo, s.velo),
        valid=torch.cat([p.valid, s_valid], dim=0),
        class_id=cat(p.class_id, s.class_id),
        difficulty=cat(p.difficulty, s.difficulty),
    )


def mine_sequence(
    frames: List[Frame],
    detect_fn: Callable[[Frame], Boxes],
    cfg: MiningCfg,
    bev: BevSetup,
    detect_batch_fn: Optional[Callable[[List[Frame]], List[Boxes]]] = None,
) -> Dict[str, object]:
    """Returns {"mined_db": ..., "raw_db": ..., "augm_db": ...,
    "num_tracks": int}.

    detect_batch_fn, when given, batches detection inference in fixed-size
    device chunks (one predict dispatch per chunk instead of one per frame —
    mining inference was batch-1 per frame in the reference,
    tracking.py:639-644 DataLoader(batch_size=1)). Chunks are computed
    lazily INSIDE the frame loop so cfg.timeout_s bounds the dominant
    inference cost too (the reference checks its budget between frames,
    tracking.py:594; precomputing the whole sequence up front would let a
    long sequence blow past the watchdog before tracking even starts)."""
    import time as _time

    tracker = FlowBasedBoxTracker(cfg.box_matching_threshold_m)
    raw_db: Dict[str, dict] = {}
    t_start = _time.time()

    pre_boxes: List[Boxes] = []
    detect_chunk = 8  # frames per lazy detect_batch_fn call

    for fi, frame in enumerate(frames):
        if cfg.timeout_s and _time.time() - t_start > cfg.timeout_s:
            print(
                f"mining watchdog: timeout after "
                f"{len(tracker.boxes_sensor)} frames — finishing early"
            )
            break
        if detect_batch_fn is not None and fi >= len(pre_boxes):
            pre_boxes.extend(detect_batch_fn(frames[fi : fi + detect_chunk]))
        # fixed-capacity, includes NMS
        boxes = (
            pre_boxes[fi] if detect_batch_fn is not None else detect_fn(frame)
        )
        dev = boxes.pos.device
        boxes, st1_T_b, stm1_T_b = _mine_frame_device(
            boxes,
            torch.as_tensor(frame.pcl, device=dev),
            torch.as_tensor(frame.valid, device=dev),
            torch.as_tensor(frame.flow, device=dev),
            torch.as_tensor(frame.odom_ta_tb, dtype=torch.float32, device=dev),
            torch.as_tensor(np.linalg.inv(frame.odom_ta_tb),
                            dtype=torch.float32, device=dev),
            bev,
            int(cfg.min_points_in_box),
            bool(cfg.drop_boxes_on_bev_border),
            bool(cfg.align_yaw_with_motion),
        )
        # ONE host transfer for everything this frame produced
        v, det, st1_T_b, stm1_T_b = _frame_to_host(boxes, st1_T_b, stm1_T_b)
        raw_db[frame.sample_id] = {
            "lidar_T_box": box_poses(det),
            "raw_box": {k: x.copy() for k, x in det.items()},
            "track_id": -np.ones(len(det["pos"]), np.int64),
        }
        tracker.update(
            det,
            np.asarray(st1_T_b, np.float64)[v],
            np.asarray(stm1_T_b, np.float64)[v],
            frame.odom_ta_tb,
            per_box_extra=[frame.sample_id] * int(v.sum()),
        )

    tracker.run_tracker()
    ids, ages = tracker.get_track_ids_and_ages()
    boxes_sensor = tracker.get_boxes_in_sensor_coordinates()
    w_Ts = tracker.w_Ts
    n_t = len(boxes_sensor)  # may be < len(frames) after a watchdog timeout

    mined: Dict[str, dict] = {
        f.sample_id: {
            "lidar_T_box": np.zeros((0, 4, 4), np.float64),
            "raw_box": {
                k: np.zeros((0, v.shape[-1]), np.float32)
                for k, v in (boxes_sensor[0].items() if boxes_sensor else [])
            },
            "track_id": np.zeros((0,), np.int64),
        }
        for f in frames
    }
    augm_db = empty_augm_db()
    num_tracks = 0
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    all_ids = (
        np.unique(np.concatenate(ids)) if any(len(i) for i in ids) else []
    )

    for tid in all_ids:
        times = [t for t in range(n_t) if (ids[t] == tid).any()]
        if not times:
            continue
        age = max(int(ages[t][np.argmax(ids[t] == tid)]) for t in times)
        if age + 1 < cfg.min_track_age:
            continue
        idx_at = {t: int(np.argmax(ids[t] == tid)) for t in times}
        confs = np.array(
            [boxes_sensor[t]["probs"][idx_at[t], 0] for t in times]
        )
        if np.median(confs) < cfg.track_confidence_threshold:
            continue

        track_sensor: BoxArr = {
            k: np.stack([boxes_sensor[t][k][idx_at[t]] for t in times])
            for k in boxes_sensor[0]
        }
        track_world: BoxArr = {
            k: np.stack(
                [tracker.boxes_world[t][k][idx_at[t]] for t in times]
            )
            for k in boxes_sensor[0]
        }
        keep, _ = decide_keep_or_drop_track(
            track_world,
            min_track_obj_speed_mps=cfg.min_track_obj_speed_mps,
            time_between_frames_s=cfg.time_between_frames_s,
            is_flow_cluster_detector=cfg.is_flow_cluster_detector,
            flow_cluster_min_travel_dist_m=cfg.flow_cluster_min_travel_dist_m,
        )
        if not keep:
            continue

        # local refinement in sensor coords
        track_sensor = refine_track_boxes(
            track_sensor,
            [frames[t].pcl[frames[t].valid] for t in times],
            dims_quantile=cfg.dims_quantile,
            fit_rot=cfg.fit_rot,
            fit_pos=cfg.fit_pos,
            device=dev,
        )
        # jerk smoothing in world coords
        tw = {
            k: np.stack(
                [
                    transform_boxes(
                        {kk: vv[i : i + 1] for kk, vv in track_sensor.items()},
                        w_Ts[t],
                    )[k][0]
                    for i, t in enumerate(times)
                ]
            )
            for k in track_sensor
        }
        if len(times) > MIN_TRACK_LEN_FOR_SMOOTHING:
            if cfg.track_smoothing_method == "bike_model":
                vlen = float(
                    np.median(tw["dims"][:, 0])
                    if "dims" in tw
                    else cfg.vehicle_length_fallback_m
                )
                pos, rot, velo = smooth_track_bike_model(
                    f32(tw["pos"])[None],
                    torch.ones((1, len(times)), dtype=torch.bool, device=dev),
                    f32(tw["rot"])[None],
                    f32([vlen]),
                    time_between_frames_s=cfg.time_between_frames_s,
                    max_iters=cfg.smoothing_iters,
                )
            else:
                pos, rot, velo = smooth_track_jerk(
                    f32(tw["pos"])[None],
                    torch.ones((1, len(times)), dtype=torch.bool, device=dev),
                    f32(tw["rot"])[None],
                    max_iters=cfg.smoothing_iters,
                )
            tw["pos"] = pos[0].cpu().numpy()
            tw["rot"] = rot[0].cpu().numpy()
            tw["velo"] = velo[0].cpu().numpy() / cfg.time_between_frames_s
        # back to sensor coords per frame
        for i, t in enumerate(times):
            one_world = {k: v[i : i + 1] for k, v in tw.items()}
            one_sensor = transform_boxes(one_world, np.linalg.inv(w_Ts[t]))
            sid = frames[t].sample_id
            e = mined[sid]
            e["lidar_T_box"] = np.concatenate(
                [e["lidar_T_box"], box_poses(one_sensor)]
            )
            for k in one_sensor:
                e["raw_box"][k] = np.concatenate(
                    [e["raw_box"].get(k, np.zeros((0, one_sensor[k].shape[-1]), np.float32)), one_sensor[k]]
                )
            e["track_id"] = np.concatenate([e["track_id"], [tid]])

            # augmentation snippet: points inside the box, box coords
            # (tracking.py:1568-1611)
            pcl = frames[t].pcl[frames[t].valid]
            rows = (
                frames[t].lidar_rows[frames[t].valid]
                if frames[t].lidar_rows is not None
                else np.zeros(len(pcl), np.int32)
            )
            pose = box_poses(one_sensor)[0]
            inv = np.linalg.inv(pose)
            p_box = pcl[:, :3] @ inv[:3, :3].T + inv[:3, 3]
            inside = np.all(
                np.abs(p_box) <= cfg.snippet_bloat * 0.5 * one_sensor["dims"][0],
                axis=-1,
            )
            if inside.sum() == 0:
                continue
            snippet = np.concatenate(
                [p_box[inside], pcl[inside][:, -1:]], axis=-1
            ).astype(np.float32)
            augm_db["pcl_in_box_cosy"].append(snippet)
            augm_db["lidar_rows"].append(rows[inside])
            augm_db["boxes"].append(
                {k: v[0] for k, v in one_sensor.items()}
            )
            augm_db["box_T_sensor"].append(inv)
            augm_db["unique_track_id"].append(int(tid))
        num_tracks += 1

    return {
        "mined_db": mined,
        "raw_db": raw_db,
        "augm_db": augm_db,
        "num_tracks": num_tracks,
    }
