"""LISO self-training rounds orchestration (port of
liso_tpu/train/liso_loop.py).

Behavioral reference: liso/kabsch/liso_cli.py:58-723 (main loop). Every
`steps_per_round` steps (and at step 0) the current detector — round 0: the
flow-cluster bootstrap — re-mines the box DB and augmentation DB over whole
drive sequences (`mine`), the train dataset is rebuilt with the new DBs,
and the network and optimizer are optionally reset
(drop_net_weights_every_nth_round, liso_cli.py:166-178,687-696). Training
itself is the detector's train step on the mined boxes plus boxes pasted
from the augmentation DB on the host (`_prepare_batch`). `validate`
evaluates the detector through `eval.run_val`; `save` / `restore` carry
the train state and the newest mined DBs.

The detector and every device program run on the card unless the caller
passes `device="cpu"`; without CUDA the constructor raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import pickle
import time
import zipfile
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import yaml

from liso_tpu_torch.data.augmentation import BoxAugmCfg, paste_boxes_into_sample
from liso_tpu_torch.data.dataset import DataCfg, LidarDataset, pad_to
from liso_tpu_torch.data.pipeline import Prefetcher
from liso_tpu_torch.eval.run_val import mined_db_predictor, run_val
from liso_tpu_torch.models.box_decode import BoxPredictionCfg
from liso_tpu_torch.models.flow_cluster_detector import (
    FlowClusterCfg,
    detect_boxes_from_flow,
)
from liso_tpu_torch.models.layers import init_weights
from liso_tpu_torch.ops.bev import point_cell_ids
from liso_tpu_torch.ops.boxes import Boxes
from liso_tpu_torch.serve import resolve_device
from liso_tpu_torch.tracker.dbs import (
    empty_augm_db,
    finalize_augm_db,
    load_augm_db,
    load_mined_boxes_db,
    merge_finalized_augm_dbs,
    save_augm_db,
    save_mined_boxes_db,
    shrink_augm_db,
)
from liso_tpu_torch.tracker.mining import (
    Frame,
    MiningCfg,
    mine_sequence,
    union_proposals,
)
from liso_tpu_torch.train.detector_train import DetectorTrainer
from liso_tpu_torch.train.pointpillars_train import PointPillarsTrainer
from liso_tpu_torch.train.pointrcnn_train import PointRCNNTrainer
from liso_tpu_torch.utils import trace
from liso_tpu_torch.utils.atomic import publish_text
from liso_tpu_torch.utils.checkpoint import (
    check_checkpoint_config_sanity,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from liso_tpu_torch.utils.config import to_plain
from liso_tpu_torch.utils.tb import TBFactory

# what reading a missing or half-written DB file raises: the JAX loop
# catches only the first two, so a truncated tracked.npz (BadZipFile) or
# augm_db.npy (UnpicklingError) stops its resume
_DB_READ_ERRORS = (OSError, ValueError, EOFError, zipfile.BadZipFile,
                   pickle.UnpicklingError)


def frames_from_dataset(dataset: LidarDataset, idxs: List[int]) -> List[Frame]:
    """The mining frames of `idxs`: always the consecutive pair t0 -> t1
    and no augmentation (the dataset's is switched off meanwhile), every
    cloud padded to n_max."""
    frames = []
    saved_augm = dataset.augmentation
    dataset.augmentation = None
    n_max = int(dataset.cfg.n_max)
    try:
        for i in idxs:
            s = dataset.get_pair(i, "t0", "t1")
            v = s.frame_t0.valid
            pcl, pvalid = pad_to(s.frame_t0.pcl[v], n_max)
            flow, _ = pad_to(s.flow_t0_t1[v], n_max)
            rows, _ = pad_to(s.frame_t0.rows[v], n_max)
            frames.append(
                Frame(
                    sample_id=s.sample_id,
                    pcl=pcl,
                    valid=pvalid,
                    flow=flow,
                    odom_ta_tb=np.asarray(s.odom_t0_t1, np.float64),
                    lidar_rows=rows,
                )
            )
    finally:
        dataset.augmentation = saved_augm
    return frames


def _pad_frame_points(frame: Frame, n_max: int):
    """Pad a mining Frame's cloud to n_max, keeping its own validity mask
    (padding rows stay invalid; hand-built Frames may be compact)."""
    pts, fresh = pad_to(frame.pcl, n_max)
    vals, _ = pad_to(frame.valid, n_max)
    return pts, vals.astype(bool) & fresh


def db_digest(db: Dict[str, dict]) -> str:
    """sha256 (16 hex digits) of a mined DB: every sample's arrays in
    sorted key order, so that workers can show they hold the same DB."""
    h = hashlib.sha256()

    def walk(node):
        for k in sorted(node):
            h.update(str(k).encode())
            v = node[k]
            if isinstance(v, dict):
                walk(v)
            else:
                h.update(np.ascontiguousarray(np.asarray(v)).tobytes())

    walk(db)
    return h.hexdigest()[:16]


def merge_mined_dbs(dbs: List[Dict[str, dict]]) -> Dict[str, dict]:
    """Merge per-worker mined DBs (sequences are disjoint, so keys never
    collide)."""
    out: Dict[str, dict] = {}
    for db in dbs:
        out.update(db)
    return out


@contextlib.contextmanager
def cudnn_deterministic(on: bool = True):
    """cuDNN restricted to its deterministic algorithms while the block
    runs (when `on`); the caller's setting is put back after it."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = saved or on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


@contextlib.contextmanager
def one_pass(loader: Prefetcher):
    """One pass's iterator over `loader`; on exit the iterator (its producer
    thread) and then the loader's worker pool are stopped."""
    it = iter(loader)
    try:
        yield it
    finally:
        it.close()
        loader.close()


def detector_predictor(det: DetectorTrainer, device):
    """run_val's predictor for a detector: each batch's clouds go to
    `device`, predict_step runs there, and its boxes come back as numpy."""

    def predict(batch):
        boxes = det.predict_step(
            torch.as_tensor(batch["pcl_t0"], device=device),
            torch.as_tensor(batch["valid_t0"], device=device),
        )
        return {k: getattr(boxes, k).cpu().numpy()
                for k in ("pos", "dims", "rot", "probs", "velo", "valid")}

    return predict


def box_prediction_cfg(cfg) -> BoxPredictionCfg:
    """The box representation of `cfg.box_prediction`."""
    bp = cfg.box_prediction
    return BoxPredictionCfg(
        position_method=bp.position_representation.method,
        num_box_pos_dims=int(bp.position_representation.num_box_pos_dims),
        box_z_pos_prior_min=float(bp.position_representation.box_z_pos_prior_min),
        box_z_pos_prior_max=float(bp.position_representation.box_z_pos_prior_max),
        dimensions_method=bp.dimensions_representation.method,
        box_len_prior_min=float(bp.dimensions_representation.box_len_prior_min),
        box_len_prior_max=float(bp.dimensions_representation.box_len_prior_max),
        rotation_method=bp.rotation_representation.method,
        activations=dict(bp.activations),
    )


def make_trainer(cfg, bev, *, group=None, device=None):
    """The trainer of `cfg.network.name`: DetectorTrainer for centerpoint
    (baseline or not, `network.centerpoint.use_baseline_parameters`) and
    transfusion, PointPillarsTrainer, PointRCNNTrainer. OneCycle spans
    the whole reset period, steps_per_round x
    drop_net_weights_every_nth_round (+2), as in the reference
    (liso_cli.py:806-820). Every network's trainer takes `group`, a
    process group over which its step is sharded (parallel/mesh.py)."""
    opt = cfg.optimization
    if opt.rounds.active:
        drop = max(int(opt.rounds.drop_net_weights_every_nth_round), 1)
        steps = int(opt.rounds.steps_per_round) * drop + 2
    else:
        steps = int(opt.num_training_steps) + 2
    common = dict(
        max_lr=float(opt.learning_rate),
        total_steps=steps,
        nms_iou_threshold=float(cfg.nms_iou_threshold),
        post_max_boxes=int(cfg.data.tracking_cfg.max_num_boxes_after_nms),
        confidence_threshold=float(
            opt.rounds.confidence_threshold_mined_boxes
        ),
        group=group,
        device=device,
    )
    name = cfg.network.name
    if name == "pointpillars":
        return PointPillarsTrainer(bev, **common)
    if name == "pointrcnn":
        return PointRCNNTrainer(bev, **common)
    return DetectorTrainer(
        bev,
        network=name,
        box_cfg=box_prediction_cfg(cfg),
        use_baseline_parameters=bool(
            cfg.network.centerpoint.use_baseline_parameters
        ),
        **common,
    )


def _last_s(*names: str) -> float:
    """The seconds of the spans' last calls, summed."""
    return sum(trace.stats(n)["last_ms"] for n in names) * 1e-3


class LisoSelfTraining:
    def __init__(
        self,
        cfg,  # Config tree (liso_config.yml semantics)
        train_dataset_factory: Callable[[Optional[dict]], LidarDataset],
        val_dataset: Optional[LidarDataset],
        log_dir,
        data_cfg: DataCfg,
        world_size: int = 1,
        worker_id: int = 0,
        device=None,
    ):
        """world_size/worker_id > (1, 0): mining shards the sequences by
        `seq_idx % world_size == worker_id` and the workers' DBs are merged
        through the shared log_dir."""
        assert 0 <= worker_id < world_size, (worker_id, world_size)
        self.device = resolve_device(device)
        self.world_size = int(world_size)
        self.worker_id = int(worker_id)
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.bev = data_cfg.bev
        self.train_dataset_factory = train_dataset_factory
        self.val_dataset = val_dataset
        self.log_dir = Path(log_dir)
        self.tb = TBFactory(self.log_dir / "tb")
        self.tb("train").add_text(
            "config", "```\n" + yaml.safe_dump(to_plain(cfg)) + "\n```", 0)

        tc = cfg.data.tracking_cfg
        self.mining_cfg_bootstrap = MiningCfg(
            min_track_age=int(tc.min_track_age),
            track_confidence_threshold=float(
                cfg.optimization.rounds.confidence_threshold_mined_boxes
            ),
            min_points_in_box=int(tc.min_points_in_box),
            box_matching_threshold_m=float(tc.track_matching_threshold_m),
            min_track_obj_speed_mps=float(
                tc.flow_cluster_detector_min_obj_speed_mps
            ),
            flow_cluster_min_travel_dist_m=float(
                tc.flow_cluster_detector_min_travel_dist_filter_m
            ),
            is_flow_cluster_detector=True,
            dims_quantile=0.95,
            fit_rot=bool(tc.fit_box_to_points.fit_rot),
            fit_pos=bool(tc.fit_box_to_points.fit_pos),
        )
        self.mining_cfg_detector = self.mining_cfg_bootstrap._replace(
            is_flow_cluster_detector=False,
            align_yaw_with_motion=bool(tc.align_predicted_boxes_using_flow),
            dims_quantile=0.6,
        )

        self.box_cfg = box_prediction_cfg(cfg)
        self.trainer = self._make_trainer()
        # the detector that trains and mines in rounds >= 1: `trainer`,
        # which holds its train state (in JAX the train state itself); None
        # until the first step, and again from a weight reset to the next
        # step (_init_detector)
        self.state: Optional[DetectorTrainer] = None
        self.round_idx = 0
        self.mined_db: Optional[dict] = None
        self.augm_db: Optional[dict] = None
        self._augm_db_final: Optional[dict] = None
        self.rng = np.random.RandomState(int(cfg.seed))
        boxes = cfg.data.augmentation.boxes
        self.box_augm_cfg = BoxAugmCfg(
            max_num_objs=int(boxes.max_num_objs),
            use_raydrop_augm=bool(boxes.use_raydrop_augm),
            max_scale_delta=float(boxes.max_scale_delta),
        )

    def _make_trainer(self, group=None):
        """The trainer of `network.name` (make_trainer); the loop's own
        trainer has none: its workers train replicas, as the JAX loop's
        hosts do."""
        return make_trainer(self.cfg, self.bev, group=group,
                            device=self.device)

    # ------------------------------------------------------------------
    def _bootstrap_detect_fn(self):
        """Frame -> the flow-cluster boxes (k = max_num_boxes_after_nms) on
        the device; cached, since union mining asks for it every round."""
        cached = getattr(self, "_fc_detect_cached", None)
        if cached is not None:
            return cached
        bev, dev = self.bev, self.device
        fc_cfg = FlowClusterCfg(
            min_residual_flow_thresh_mps=1.0,
            k_max=int(self.cfg.data.tracking_cfg.max_num_boxes_after_nms),
        )
        td = float(self.data_cfg.time_delta_s)

        def detect(frame: Frame) -> Boxes:
            pcl = torch.as_tensor(frame.pcl, device=dev)
            valid = torch.as_tensor(frame.valid, device=dev)
            cell, _, _ = point_cell_ids(pcl[:, :2], bev, valid)
            return detect_boxes_from_flow(
                pcl, valid, cell, torch.as_tensor(frame.flow, device=dev),
                torch.as_tensor(frame.odom_ta_tb, dtype=torch.float32,
                                device=dev),
                pcl, valid, td, bev, fc_cfg,
            )

        self._fc_detect_cached = detect
        return detect

    def _detector_detect_fn(self):
        """Frame -> the detector's boxes, one frame per predict_step."""
        det, n_max, dev = self.state, self.data_cfg.n_max, self.device

        def detect(frame: Frame) -> Boxes:
            pts, valid = _pad_frame_points(frame, n_max)
            boxes = det.predict_step(torch.as_tensor(pts, device=dev)[None],
                                     torch.as_tensor(valid, device=dev)[None])
            return _sample(boxes, 0)

        return detect

    def _detector_detect_batch_fn(self, batch_size: int = 8):
        """Frames -> the detector's boxes, `batch_size` frames per
        predict_step (the last chunk repeats its final frame, so every call
        has one shape). The boxes stay on the device."""
        det, n_max, dev = self.state, self.data_cfg.n_max, self.device

        def detect_many(frames) -> list:
            out = []
            for i in range(0, len(frames), batch_size):
                chunk = frames[i : i + batch_size]
                n_real = len(chunk)
                while len(chunk) < batch_size:
                    chunk = list(chunk) + [chunk[-1]]
                padded = [_pad_frame_points(f, n_max) for f in chunk]
                pts = torch.as_tensor(np.stack([p for p, _ in padded]), device=dev)
                valid = torch.as_tensor(np.stack([v for _, v in padded]),
                                        device=dev)
                boxes = det.predict_step(pts, valid)
                out.extend(_sample(boxes, j) for j in range(n_real))
            return out

        return detect_many

    # ------------------------------------------------------------------
    def mine(self, dataset: LidarDataset, world_size: Optional[int] = None,
             worker_id: Optional[int] = None, gather: bool = True) -> None:
        """The mining pass of one round (liso_cli.py:180-272): round 0 with
        the flow-cluster bootstrap, later rounds with the detector in
        `state`. Sequences are independent: with world_size > 1 each worker
        mines `seq_idx % world_size == worker_id`, saves its DBs under the
        shared log_dir and, with gather=True, waits for every worker's
        marker file and merges the DBs; gather=False publishes this
        worker's shard only. Sets mined_db and augm_db and writes them to
        log_dir/mined_round_<round>/."""
        world_size = self.world_size if world_size is None else world_size
        worker_id = self.worker_id if worker_id is None else worker_id
        t0 = time.time()
        bootstrap = self.round_idx == 0 or self.state is None
        detect_fn = (
            self._bootstrap_detect_fn()
            if bootstrap
            else self._detector_detect_fn()
        )
        detect_batch_fn = None if bootstrap else self._detector_detect_batch_fn()
        mcfg = (
            self.mining_cfg_bootstrap
            if self.round_idx == 0
            else self.mining_cfg_detector
        )
        union_on = bool(
            getattr(self.cfg.optimization.rounds, "mine_proposal_union", False)
        )
        if not bootstrap and union_on:
            # flow-cluster proposals unioned into detector-mode mining
            # (tracker/mining.union_proposals)
            fc_detect = self._bootstrap_detect_fn()
            det_detect = detect_fn
            det_batch = detect_batch_fn
            thresh = float(self.cfg.data.tracking_cfg.track_matching_threshold_m)

            def detect_fn(frame):  # noqa: F811 — deliberate rebind
                return union_proposals(det_detect(frame), fc_detect(frame),
                                       thresh)

            def detect_batch_fn(frames):  # noqa: F811
                return [union_proposals(p, fc_detect(f), thresh)
                        for p, f in zip(det_batch(frames), frames)]

        # the reference's stop conditions (tracking.py:594): enough tracks
        # or the timeout; both unset => every sequence
        tc = self.cfg.data.tracking_cfg
        min_num_boxes = getattr(tc, "min_num_boxes", None)
        min_num_boxes = (
            float("inf") if min_num_boxes in (None, "None") else int(min_num_boxes)
        )
        timeout_s = getattr(tc, "timeout_s", None)
        timeout_at = (
            t0 + float(timeout_s) if timeout_s not in (None, "None")
            else float("inf")
        )
        mined: Dict[str, dict] = {}
        augm = None
        n_seqs = 0
        num_successful_tracks = 0
        sequences = [
            s for i, s in enumerate(self._sequences(dataset))
            if i % world_size == worker_id
        ]
        for seq in sequences:
            if num_successful_tracks >= min_num_boxes:
                print(f"mining: reached min_num_boxes={min_num_boxes} after "
                      f"{n_seqs} sequences — stopping early")
                break
            if time.time() > timeout_at:
                print(f"mining: timeout after {timeout_s}s — stopping early")
                break
            frames = frames_from_dataset(dataset, seq)
            result = mine_sequence(frames, detect_fn, mcfg, self.bev,
                                   detect_batch_fn=detect_batch_fn)
            mined.update(result["mined_db"])
            num_successful_tracks += int(result["num_tracks"])
            if augm is None:
                augm = result["augm_db"]
            else:
                for k in augm:
                    augm[k].extend(result["augm_db"][k])
            n_seqs += 1
        if augm is None:  # an empty shard: an empty DB merges cleanly
            augm = empty_augm_db()
        augm = shrink_augm_db(augm, float(tc.max_augm_db_size_mb))
        out = self.log_dir / f"mined_round_{self.round_idx}"
        if world_size > 1:
            # publish this worker's shard; the marker is written after both
            # DB files, so a reader never sees a half-written npz
            save_mined_boxes_db(mined, out / f"tracked_worker{worker_id}")
            save_augm_db(augm, out / f"augm_db_worker{worker_id}")
            (out / f".done_worker{worker_id}").touch()
            if gather:
                mined, augm_final = self._gather_worker_dbs(out, world_size)
                print(f"round {self.round_idx}: worker {worker_id} merged "
                      f"{world_size} shards, DB digest {db_digest(mined)}")
                self.mined_db = mined
                self.augm_db = None
                self._augm_db_final = augm_final
                if worker_id == 0:  # the merged DBs for resume and eval
                    save_mined_boxes_db(mined, out / "tracked")
                    out.mkdir(parents=True, exist_ok=True)
                    np.save(out / "augm_db.npy", augm_final, allow_pickle=True)
            else:  # offline merge: keep this worker's shard only
                self.mined_db, self.augm_db = mined, augm
                self._augm_db_final = None
        else:
            self.mined_db, self.augm_db = mined, augm
            self._augm_db_final = None
            save_mined_boxes_db(mined, out / "tracked")
            save_augm_db(augm, out / "augm_db")
        # config and box statistics next to the DBs (tracking.py:1938-1950)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "tracking_cfg.yaml", "w") as f:
            yaml.safe_dump(to_plain(tc), f, sort_keys=False)
        confs = np.concatenate(
            [np.asarray(v["raw_box"]["probs"]).reshape(-1)
             for v in mined.values() if len(v.get("track_id", ()))]
            or [np.zeros(0, np.float32)]
        )
        stats = {
            "num_boxes": int(confs.size),
            "conf_mean": float(confs.mean()) if confs.size else 0.0,
            "conf_min": float(confs.min()) if confs.size else 0.0,
            "conf_max": float(confs.max()) if confs.size else 0.0,
        }
        with open(out / "tracked_box_stats.yaml", "w") as f:
            yaml.safe_dump(stats, f)
        n_boxes = sum(len(v["track_id"]) for v in mined.values())
        w = self.tb("train", "mining/")
        w.add_scalar("num_mined_boxes", n_boxes, self.round_idx)
        # augm-DB snippet grids (visualize_box_augmentation_database.py)
        from liso_tpu_torch.visu.augm_db_image import grid_of_snippets

        for pi, page in enumerate(grid_of_snippets(augm, num_boxes=16, per_row=4)):
            w.add_image(f"augm_db/snippets_{pi}", page, self.round_idx)
        # animated summary of a sequence this worker mined
        # (tracking.py:417-473), cached for the mining CLI's GIF
        self._last_seq_frames = (
            self.render_sequence_frames(dataset, max_frames=20,
                                        seq_idxs=sequences[0])
            if sequences else []
        )
        w.add_gif("tracked_sequence", self._last_seq_frames[:12], self.round_idx)
        w.add_scalar("mining_time_s", time.time() - t0, self.round_idx)
        print(f"round {self.round_idx}: mined {n_boxes} boxes over {n_seqs} "
              f"sequences in {time.time() - t0:.0f}s")

    def _assert_replicas_in_sync(self, step: int, poll_s: float = 1.0,
                                 timeout_s: float = 600.0) -> None:
        """Multi-worker training is lock-step replicated: every worker
        trains the same model on the same batches, so the replicas'
        parameters must stay bit-identical. Each worker publishes a sha256
        of its detector's parameters (by name, in sorted order) under the
        shared log_dir and compares it with every peer's; a mismatch raises
        RuntimeError (divergent replicas would merge boxes of different
        detectors into the next round's DB), a peer that publishes nothing
        within `timeout_s` TimeoutError. A no-op with one worker."""
        if self.world_size <= 1 or self.state is None:
            return
        h = hashlib.sha256()
        params = self.state.params
        for name in sorted(params):
            h.update(np.ascontiguousarray(
                params[name].detach().cpu().numpy()).tobytes())
        digest = h.hexdigest()
        out = self.log_dir / f"param_sync_step_{step}"
        out.mkdir(parents=True, exist_ok=True)
        # whole or not at all: a peer that read a half-written digest would
        # take equal replicas for divergent ones
        publish_text(out / f"digest_worker{self.worker_id}", digest)
        deadline = time.time() + timeout_s
        peers = {}
        missing = set(range(self.world_size)) - {self.worker_id}
        while missing:
            for i in list(missing):
                f = out / f"digest_worker{i}"
                if f.exists():
                    peers[i] = f.read_text()
                    missing.discard(i)
            if missing:
                if time.time() > deadline:
                    raise TimeoutError(
                        f"param sync at step {step}: workers "
                        f"{sorted(missing)} never published digests")
                time.sleep(poll_s)
        bad = {i: d for i, d in peers.items() if d != digest}
        if bad:
            raise RuntimeError(
                f"replica divergence at step {step}: worker {self.worker_id} "
                f"params digest {digest[:12]} != workers "
                f"{ {i: d[:12] for i, d in bad.items()} } — lock-step "
                f"training requires bit-identical replicas")

    def _gather_worker_dbs(self, out: Path, world_size: int,
                           poll_s: float = 2.0, timeout_s: float = 3600.0):
        """Wait for every worker's `.done_worker{i}` marker under `out`,
        then merge the mined dicts (disjoint shards: a dict union) and the
        finalized augm DBs (concatenated, track ids re-offset)."""
        deadline = time.time() + timeout_s
        missing = set(range(world_size))
        while missing:
            missing = {i for i in missing
                       if not (out / f".done_worker{i}").exists()}
            if not missing:
                break
            if time.time() > deadline:
                raise TimeoutError(
                    f"sharded mining gather: workers {sorted(missing)} did "
                    f"not publish DBs under {out} within {timeout_s}s")
            time.sleep(poll_s)
        mined = merge_mined_dbs([
            load_mined_boxes_db(out / f"tracked_worker{i}.npz")
            for i in range(world_size)
        ])
        augm = merge_finalized_augm_dbs([
            np.load(out / f"augm_db_worker{i}.npy", allow_pickle=True).item()
            for i in range(world_size)
        ])
        return mined, augm

    def render_sequence_frames(self, dataset: LidarDataset, max_frames: int = 20,
                               grid_hw=(256, 256), seq_idxs=None):
        """BEV images of one sequence with the mined boxes drawn (the TB GIF
        and the mining CLI's); seq_idxs defaults to the first sequence."""
        from liso_tpu_torch.visu.bbox_image import render_frame

        seq = (seq_idxs if seq_idxs is not None
               else self._sequences(dataset)[0])[:max_frames]
        predict = mined_db_predictor(self.mined_db or {})
        images = []
        for f in frames_from_dataset(dataset, seq):
            pred = predict({"sample_id": [f.sample_id]})
            v = pred["valid"][0]
            boxes = {k: np.asarray(x[0])[v] for k, x in pred.items()
                     if k != "valid"}
            images.append(render_frame(
                np.asarray(f.pcl)[np.asarray(f.valid, bool)][:, :2],
                boxes if len(boxes["pos"]) else None,
                self.bev.bev_range_m, grid_hw=grid_hw,
            ))
        return images

    def _sequences(self, dataset: LidarDataset) -> List[List[int]]:
        try:
            n = getattr(dataset, "num_sequences", 1)
            return [dataset.get_consecutive_sample_idxs_for_sequence(i)
                    for i in range(n)]
        except NotImplementedError:
            return [list(range(len(dataset)))]

    # ------------------------------------------------------------------
    def _prepare_batch(self, batch: dict):
        """Copy-paste augmentation and the target boxes on the host (numpy;
        `rng` is drawn as in the JAX package): boxes from the augmentation
        DB, stacked once per round, are pasted into each cloud and written
        into the free target slots. Then one move to the trainer's device,
        through pinned host memory on cuda. Returns (points, valid, target
        Boxes). Spans (`utils/trace.py`): `det.paste` to the padded, pasted
        arrays and targets, `det.h2d` for the copies to the device; counters
        `det.boxes_pasted` and `det.points_pasted` (the points that land in
        the padded clouds)."""
        with trace.span("det.paste"):
            pcl, valid, targets = self._paste(batch)
        dev = self.device
        pin = dev.type == "cuda"

        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return (t.pin_memory() if pin else t).to(dev, non_blocking=True)

        with trace.span("det.h2d"):
            boxes = Boxes(
                pos=put(targets["pos"]),
                dims=put(targets["dims"]),
                rot=put(targets["rot"]),
                probs=put(targets["probs"]),
                velo=put(targets["velo"]) if "velo" in targets else None,
                valid=put(targets["valid"]),
            ).with_defaults()
            return put(pcl), put(valid), boxes

    def _paste(self, batch: dict):
        """`_prepare_batch`'s host part: (points, valid, target arrays) of
        the batch with the augmentation DB's boxes pasted in."""
        pcl = np.array(batch["pcl_t0"])
        valid = np.array(batch["valid_t0"])
        targets = {k: np.array(v) for k, v in batch["target_boxes"].items()}
        has_augm = self._augm_db_final is not None or (
            self.augm_db is not None and len(self.augm_db["boxes"]) > 0
        )
        if has_augm and self.cfg.data.augmentation.boxes.active:
            if self._augm_db_final is None:  # stack once per mining round
                self._augm_db_final = finalize_augm_db(self.augm_db)
            db = self._augm_db_final
            if len(db["boxes"].get("pos", ())) == 0:
                db = None  # resume-loaded DB fully filtered: nothing to paste
        else:
            db = None
        if db is not None:
            b, n_max = valid.shape
            for i in range(b):
                base = pcl[i][valid[i]]
                rows = np.zeros(len(base), np.int64)
                new_pcl, _, pasted = paste_boxes_into_sample(
                    base, rows, db, self.rng, self.bev.bev_range_m,
                    self.box_augm_cfg,
                )
                p_padded, v_padded = pad_to(new_pcl, n_max)
                pcl[i], valid[i] = p_padded, v_padded
                trace.count("det.boxes_pasted", len(pasted["pos"]))
                trace.count("det.points_pasted",
                            min(len(new_pcl), n_max) - len(base))
                if len(pasted["pos"]):
                    k_slots = targets["pos"].shape[1]
                    kv = int(targets["valid"][i].sum())
                    n_add = min(len(pasted["pos"]), k_slots - kv)
                    for key in ("pos", "dims", "rot", "probs", "velo"):
                        if key in targets:
                            targets[key][i, kv : kv + n_add] = pasted[key][:n_add]
                    targets["valid"][i, kv : kv + n_add] = True
        return pcl, valid, targets

    def _init_detector(self, seed: int) -> None:
        """A fresh detector, at the first step and after each weight reset:
        weights drawn by init_weights(model, seed) with batch-norm
        statistics (0, 1), AdamW's moments, count and step zeroed (so the
        OneCycle schedule starts again), on the trainer's device. The JAX
        loop draws its state from PRNGKey(seed) here; the two random
        streams differ, so the CPU parity tests patch this one method to
        load JAX's state for the seed."""
        init_weights(self.trainer.model, seed)
        self.trainer.reset_optimizer()
        self.state = self.trainer

    def _train_loader(self, dataset: LidarDataset) -> Prefetcher:
        """A round's loader; like the JAX one it starts at seed 0 in every
        round, so each round replays one sample order."""
        return Prefetcher(
            dataset,
            batch_size=int(self.cfg.data.batch_size),
            num_workers=int(self.cfg.data.num_workers) or 1,
        )

    def run(self, total_steps: Optional[int] = None, fast_test: bool = False,
            start_step: int = 0):
        """The rounds loop up to `total_steps` (default
        optimization.num_training_steps); returns the total loss of every
        step. start_step > 0 resumes mid-run (liso_cli.py:742-789) from the
        DBs and state that `restore` loaded: round_idx becomes the one a
        fresh run has there, so mining starts again at the next round
        boundary. Only worker 0 validates and saves."""
        opt = self.cfg.optimization
        total_steps = total_steps or int(opt.num_training_steps)
        steps_per_round = (
            int(opt.rounds.steps_per_round) if opt.rounds.active else total_steps
        )
        drop_every = int(opt.rounds.drop_net_weights_every_nth_round)
        val_every = int(self.cfg.validation.val_every_n_steps)
        save_every = int(self.cfg.checkpoint.save_model_every)

        dataset = self.train_dataset_factory(None)
        loader = None
        train_iter = None
        metrics_hist = []

        def close_loader():
            # the iterator's producer thread first, then the worker pool:
            # one live loader at a time, none left behind
            if train_iter is not None:
                train_iter.close()
            if loader is not None:
                loader.close()

        try:
            if start_step:
                self.round_idx = -(-start_step // steps_per_round)
                dataset = self.train_dataset_factory(self.mined_db)
                loader = self._train_loader(dataset)
                train_iter = iter(loader)

            for step in range(start_step, total_steps):
                if step % steps_per_round == 0:
                    # replicas must agree before mining, or the merged DB
                    # mixes boxes of different detectors
                    self._assert_replicas_in_sync(step)
                    close_loader()
                    loader = train_iter = None
                    print(f"step {step}: mining round {self.round_idx}")
                    self.mine(dataset)
                    if self.mined_db is not None and self.val_dataset is not None:
                        val_loader = Prefetcher(
                            self.val_dataset, batch_size=1, shuffle=False,
                            num_workers=2,
                        )
                        with one_pass(val_loader) as batches:
                            mined_metrics = run_val(
                                batches, mined_db_predictor(self.mined_db),
                                max_batches=4 if fast_test else None,
                                device=self.device,
                            )
                        self.tb("val", "mined_boxes/").add_scalars(
                            {k: v for k, v in mined_metrics.items()
                             if k.startswith(("mAP", "AP_overall_overall"))},
                            step,
                        )
                    dataset = self.train_dataset_factory(self.mined_db)
                    loader = self._train_loader(dataset)
                    train_iter = iter(loader)
                    if (
                        self.round_idx > 0
                        and drop_every > 0
                        and self.round_idx % drop_every == 0
                    ):
                        print(f"round {self.round_idx}: resetting net + optimizer")
                        self.state = None
                    self.round_idx += 1

                with trace.span("det.step", step=step):
                    with trace.span("det.wait") as wait:
                        try:
                            batch = next(train_iter)
                        except StopIteration:
                            train_iter = iter(loader)
                            batch = next(train_iter)
                    pts, valid, target = self._prepare_batch(batch)
                    if self.state is None:
                        # the seed is taken after round_idx moved on, as in
                        # JAX
                        self._init_detector(int(self.cfg.seed) + self.round_idx)
                    # replicas must stay bitwise equal (the replica check):
                    # the cuDNN backward's fastest algorithms sum in no
                    # fixed order
                    with cudnn_deterministic(self.world_size > 1):
                        metrics = self.state.train_step(pts, valid, target)
                    with trace.span("det.readback"):
                        loss = float(metrics["loss/total"])  # waits for the step
                metrics_hist.append(loss)
                self.tb.global_step = step
                if step % int(self.cfg.logging.log_interval) == 0:
                    self.tb("train", "loss/").add_scalars(
                        {k: float(v) for k, v in metrics.items()}, step)
                    # per-step wall-clock timers (liso_cli.py:621-633), from
                    # this step's spans: the loader's wait and the paste and
                    # copy; the train step to its loss on the host
                    wt = self.tb("train", "timing/")
                    wt.add_scalar("dataloading_s", wait.seconds + _last_s(
                        "det.paste", "det.h2d"), step)
                    wt.add_scalar("fwd_bwd_s", _last_s(
                        "det.loss", "det.backward", "det.optimizer",
                        "det.readback"), step)
                    # the paste's work so far, against `det.paste`'s total
                    self.tb("train", "augm/").add_scalars(
                        {"boxes_pasted": trace.counter("det.boxes_pasted"),
                         "points_pasted": trace.counter("det.points_pasted")},
                        step)

                # replicas train in lock-step, so only worker 0 validates
                # and saves
                if (val_every and step > 0 and step % val_every == 0
                        and self.worker_id == 0):
                    self.validate(step, fast_test)
                if (save_every and step > 0 and step % save_every == 0
                        and self.worker_id == 0):
                    self.save(step)
        finally:
            close_loader()
        self._assert_replicas_in_sync(total_steps)
        if self.state is not None and self.worker_id == 0:
            self.save(total_steps)
        return metrics_hist

    def save(self, step: int):
        """The detector's train state {model, optimizer, step} as
        ckpts/<step> (liso_cli.py:726-739); the schedule is a function of
        the restored count, so nothing else is kept."""
        save_checkpoint(self.log_dir / "ckpts", step, self.state)

    def restore(self, ckpt_dir) -> int:
        """liso_cli.py:742-789 resume: load the newest step under
        `ckpt_dir` into the trainer, and the newest complete mined and
        augmentation DBs saved beside it (a round directory that an
        interrupted `mine` left half-written is skipped). Returns the step.
        Unlike the JAX loop, which builds a state template from example
        points, it takes none: the trainer exists already."""
        ckpt_dir = Path(ckpt_dir)
        check_checkpoint_config_sanity(ckpt_dir, self.cfg)
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        restore_checkpoint(ckpt_dir, step, self.trainer)
        self.state = self.trainer
        rounds = sorted(
            ckpt_dir.parent.glob("mined_round_*"),
            key=lambda p: int(p.name.rsplit("_", 1)[-1]),
        )
        for rd in reversed(rounds):
            try:
                self.mined_db = load_mined_boxes_db(rd / "tracked.npz")
            except _DB_READ_ERRORS:
                continue
            try:
                # loaded DBs are already in the finalized (stacked) form
                self._augm_db_final = load_augm_db(rd / "augm_db.npy")
            except _DB_READ_ERRORS:
                pass
            break
        return step

    # ------------------------------------------------------------------
    def validate(self, step: int, fast_test: bool = False):
        """Evaluate the detector in `state` on the val set through run_val
        (batch 1, as liso_cli.py:665-684), then, with
        validation.num_val_on_train_steps, on the training distribution
        (the factory without mined boxes). Returns the metric dict, with the
        val-on-train mAPs under `val_on_train/`."""
        if self.val_dataset is None:
            return {}
        loader = Prefetcher(
            self.val_dataset, batch_size=1, shuffle=False, num_workers=2
        )
        # cap mid-training validation like the reference's num_val_steps
        # batches (liso_cli.py:665-684); 0/absent = full val set
        num_val = int(getattr(self.cfg.validation, "num_val_steps", 0) or 0)
        max_batches = 4 if fast_test else (num_val or None)
        dev = self.device
        predict = detector_predictor(self.state, dev)
        with one_pass(loader) as batches:
            metrics = run_val(
                batches, predict, max_batches=max_batches,
                writer=self.tb("val", "detector/"), global_step=step,
                bev_range_m=self.bev.bev_range_m, device=dev,
            )
        self.tb("val", "detector/").add_scalars(
            {k: v for k, v in metrics.items()
             if k.startswith(("mAP", "AP_overall_overall", "ATE", "AOE"))},
            step,
        )
        # second eval pass over the TRAINING distribution (val-on-train,
        # reference liso_cli.py:665-684 + main_utils.py:323-463): the
        # factory without mined boxes yields GT targets for measurement
        num_vot = int(
            getattr(self.cfg.validation, "num_val_on_train_steps", 0) or 0
        )
        if num_vot:
            vot_ds = self.train_dataset_factory(None)
            vot_loader = Prefetcher(
                vot_ds, batch_size=1, shuffle=False, num_workers=2
            )
            with one_pass(vot_loader) as batches:
                vot_metrics = run_val(
                    batches, predict,
                    max_batches=4 if fast_test else num_vot,
                    writer=self.tb("val_on_train", "detector/"),
                    global_step=step, bev_range_m=self.bev.bev_range_m,
                    device=dev,
                )
            self.tb("val_on_train", "detector/").add_scalars(
                {k: v for k, v in vot_metrics.items()
                 if k.startswith(("mAP", "AP_overall_overall", "ATE", "AOE"))},
                step,
            )
            metrics.update(
                {f"val_on_train/{k}": v for k, v in vot_metrics.items()
                 if k.startswith("mAP")}
            )
        return metrics


def _sample(boxes: Boxes, j: int) -> Boxes:
    """Sample j of batched Boxes."""
    return Boxes(**{f.name: None if getattr(boxes, f.name) is None
                    else getattr(boxes, f.name)[j]
                    for f in dataclasses.fields(boxes)})
