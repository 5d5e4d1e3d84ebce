"""Host-side dataset base: reference npy sample dicts -> fixed-shape arrays
(port of liso_tpu/data/dataset.py; numpy only, the card is reached by the
pipeline, data/pipeline.py).

Behavioral reference: liso/datasets/torch_dataset_commons.py:434-1935
(LidarDataset). The reference emits ragged tensors consumed by torch
DataLoader workers; here every sample is padded to static capacities
(N points / K boxes) on the host so batches go straight into jitted steps.

Per reference semantics kept:
  * per-sample npy dict format (pcl_t0/t1/t2 [N,4], is_ground_*,
    odom_t0_t1/odom_t0_t2 f64, kiss_odom_*, name) — identical to the
    reference ETL output (datasets/kitti/create_kitti_raw.py:119-175);
  * three point-cloud views per frame: BEV-cropped no-ground `pcl`,
    full no-ground, full with ground (torch_dataset_commons.py:1061-1106);
  * ground removal: precomputed JCP mask OR cone fallback
    (infer_ground_label_using_cone, :133-144);
  * skip-frame curriculum `use_skip_frames in {only, never, both}`
    (select_time_keys, :1485-1512);
  * SLIM flow loading from exported npz BEV grids with zero-flow-neighbor
    expansion (:590-675);
  * mined-box injection with confidence filter, probs -> 1.0 (:559-588);
  * global SE(2) augmentation applied consistently to points / odometry /
    flow / boxes (:1291-1433) — data/augmentation.py's
    `augment_sample_content`, passed in as the `augmentation` callable
    (slim_cli.make_train_dataset passes none, as the JAX package's does).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from liso_tpu_torch.ops.bev import BevSetup


class HostFrame(NamedTuple):
    pcl: np.ndarray  # [N_max, 4] no ground, BEV-cropped (zeros padded)
    valid: np.ndarray  # [N_max]
    rows: np.ndarray  # [N_max] lidar row index
    pcl_full: np.ndarray  # [M_max, 4] with ground, uncropped
    full_valid: np.ndarray  # [M_max]
    is_ground_full: np.ndarray  # [M_max]


class HostSample(NamedTuple):
    sample_id: str
    frame_t0: HostFrame
    frame_t1: HostFrame
    odom_t0_t1: np.ndarray  # [4, 4]
    odom_t1_t0: np.ndarray
    flow_t0_t1: np.ndarray  # [N_max, 3] (gt or SLIM), zeros if absent
    flow_t1_t0: np.ndarray
    time_delta_s: float
    gt_boxes: Optional[Dict[str, np.ndarray]] = None  # padded [K_max, .]
    target_boxes: Optional[Dict[str, np.ndarray]] = None  # mined or gt
    # GT flow is carried alongside the (possibly SLIM-)loaded flow so the
    # eval path can compute flow EPE against ground truth even when the
    # sample's flow_t0_t1 is the predicted SLIM flow (eval_ours.py:340-358
    # reads sample_data["gt"]["flow_ta_tb"] next to the flow source).
    gt_flow_t0_t1: Optional[np.ndarray] = None  # [N_max, 3]
    gt_moving_mask: Optional[np.ndarray] = None  # [N_max] point in moving obj


def pad_to(arr: np.ndarray, n: int, fill=0.0):
    out = np.full((n,) + arr.shape[1:], fill, arr.dtype)
    k = min(len(arr), n)
    out[:k] = arr[:k]
    valid = np.zeros(n, bool)
    valid[:k] = True
    return out, valid


def pad_boxes(boxes: Dict[str, np.ndarray], k_max: int) -> Dict[str, np.ndarray]:
    out = {}
    k = min(len(boxes["pos"]), k_max)
    for key, v in boxes.items():
        o = np.zeros((k_max,) + v.shape[1:], v.dtype)
        o[:k] = v[:k]
        out[key] = o
    out["valid"] = np.zeros(k_max, bool)
    out["valid"][:k] = True
    return out


def infer_ground_label_using_cone(
    pcl: np.ndarray, cone_z_threshold_m: float = -1.70, cone_angle_deg: float = 0.8
) -> np.ndarray:
    """torch_dataset_commons.py:133-144."""
    if cone_angle_deg > 0.0:
        d_xy = np.linalg.norm(pcl[..., 0:2], axis=-1)
        thresh = cone_z_threshold_m + np.tan(np.deg2rad(cone_angle_deg)) * d_xy
        return pcl[..., 2] < thresh
    return pcl[..., 2] < cone_z_threshold_m


def expand_valid_bev_flow_to_zero_flow_neighbors(bev_flow: np.ndarray):
    """torch_dataset_commons.py:677+: cells whose flow is zero but that have
    a non-zero neighbor inherit the neighbor mean — fixes off-by-one
    pillarization mismatches at object borders."""
    mag = np.linalg.norm(bev_flow, axis=-1)
    is_zero = mag == 0.0
    padded = np.pad(bev_flow, ((1, 1), (1, 1), (0, 0)))
    pm = np.pad(~is_zero, ((1, 1), (1, 1))).astype(np.float32)
    s = np.zeros_like(bev_flow)
    c = np.zeros_like(mag)
    for dr in range(3):
        for dc in range(3):
            h, w = mag.shape
            s += padded[dr : dr + h, dc : dc + w]
            c += pm[dr : dr + h, dc : dc + w]
    neigh_mean = s / np.maximum(c[..., None], 1.0)
    return np.where((is_zero & (c > 0))[..., None], neigh_mean, bev_flow)


class DataCfg(NamedTuple):
    bev: BevSetup = BevSetup((40.0, 40.0), (64, 64))
    n_max: int = 32768  # BEV-cropped cloud capacity
    m_max: int = 65536  # full cloud capacity
    k_max_boxes: int = 64
    pillar_height_range_m: Tuple[float, float] = (-2.0, 1.0)
    use_lidar_intensity: bool = True
    use_skip_frames: str = "both"  # only | never | both
    time_delta_s: float = 0.1
    ground_cone_z_threshold_m: float = -1.70
    # lazy ground fallback when no is_ground_* label is stored: "cone"
    # (z-threshold) or "jcp" (full JCP segmentation, the reference's lazy
    # Waymo path, waymo_torch_dataset.py:295-335)
    ground_label_source: str = "cone"
    flow_source: str = "gt"  # gt | slim path
    odom_source: str = "gt"  # gt | kiss_icp
    mined_confidence_threshold: float = 0.0


class LidarDataset:
    """Base: subclasses implement sample_files discovery +
    extract_gt_boxes; everything else is shared."""

    def __init__(
        self,
        cfg: DataCfg,
        sample_files: Sequence[Path],
        pred_flow_path: Optional[Path] = None,
        mined_boxes_db: Optional[Dict[str, dict]] = None,
        augmentation=None,  # callable(sample_content, rng) or None
        seed: int = 0,
    ):
        self.cfg = cfg
        self.sample_files = list(sample_files)
        self.pred_flow_path = Path(pred_flow_path) if pred_flow_path else None
        self.mined_boxes_db = mined_boxes_db
        self.augmentation = augmentation
        self.seed = int(seed)
        self.epoch = 0  # bumped by the loader each pass (pipeline.py)
        self.rng = np.random.RandomState(seed)
        # per-sample memo for lazily computed odometry / ground labels
        # (the reference caches its on-the-fly KISS-ICP poses + JCP labels
        # next to the data, waymo_torch_dataset.py:295-335; here they are
        # memoized in-process). Keys use the sample's stable name (stamped
        # from sample_files in _load_content — id(content) can alias after
        # GC), and the cache is LRU-bounded so long epochs over big
        # datasets don't grow it without bound.
        from collections import OrderedDict

        self._lazy_cache: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._lazy_cache_max = 4096

    def __len__(self):
        return len(self.sample_files)

    def index_rng(self, idx: int, salt: int = 0) -> np.random.RandomState:
        """Deterministic per-(seed, epoch, index) RNG. Augmentation and
        skip-frame draws become a pure function of WHICH sample is built,
        not of which worker builds it — so thread pools, fork pools, and
        lock-step multi-host replicas all produce bit-identical samples
        in any assignment order. (The reference PID-reseeds each fork
        instead, torch_dataset_commons.py:74, which is irreproducible by
        design and would desynchronize replicated DP hosts.)"""
        mix = (
            self.seed * 1000003
            + int(self.epoch) * 7919
            + int(idx) * 2654435761
            + salt * 97
        ) % (2**31 - 1)
        return np.random.RandomState(mix)

    # -- hooks ----------------------------------------------------------
    def load_sample_dict(self, idx: int) -> dict:
        return np.load(self.sample_files[idx], allow_pickle=True).item()

    def extract_gt_boxes(self, content: dict, time_key: str):
        """-> dict of box arrays or None (subclass)."""
        return None

    def get_consecutive_sample_idxs_for_sequence(self, seq_of_idx: int):
        """-> list of dataset indices forming one drive sequence
        (subclass; reference per-dataset implementations)."""
        raise NotImplementedError

    # -- processing -----------------------------------------------------
    def select_time_keys(self, rng=None) -> Tuple[str, str, float]:
        """torch_dataset_commons.select_time_keys: skip-frame curriculum."""
        mode = self.cfg.use_skip_frames
        if mode == "never":
            skip = False
        elif mode == "only":
            skip = True
        else:
            skip = bool((rng or self.rng).rand() < 0.5)
        if skip:
            return "t0", "t2", 2.0 * self.cfg.time_delta_s
        return "t0", "t1", self.cfg.time_delta_s

    def _odom(self, content: dict, a: str, b: str) -> np.ndarray:
        prefix = "kiss_odom" if self.cfg.odom_source == "kiss_icp" else "odom"
        key = f"{prefix}_{a}_{b}"
        if key in content:
            return np.asarray(content[key], np.float64)
        rev = f"{prefix}_{b}_{a}"
        if rev in content:
            return np.linalg.inv(np.asarray(content[rev], np.float64))
        # compose via t0: a_T_b = inv(t0_T_a) @ t0_T_b
        t0_a = content.get(f"{prefix}_t0_{a}")
        t0_b = content.get(f"{prefix}_t0_{b}")
        if a == "t0":
            t0_a = np.eye(4)
        if b == "t0":
            t0_b = np.eye(4)
        if t0_a is None or t0_b is None:
            return self._lazy_icp_odom(content, a, b)
        return np.linalg.inv(np.asarray(t0_a, np.float64)) @ np.asarray(
            t0_b, np.float64
        )

    def _lazy_icp_odom(self, content: dict, a: str, b: str) -> np.ndarray:
        """On-the-fly KISS-ICP-style ego-motion when the ETL stored no
        poses — the reference's lazy Waymo path
        (waymo_torch_dataset.py:295-335 runs kiss-icp per sequence and
        caches). Registers scan b onto scan a (native voxel-hash ICP,
        native/icp.cpp) and memoizes per (sample, pair)."""
        ck = (self._content_key(content), "odom", a, b)
        if ck not in self._lazy_cache:
            from liso_tpu_torch.data.icp import icp_register, voxel_downsample

            src = voxel_downsample(
                np.asarray(content[f"pcl_{b}"], np.float64)[:, :3], 1.0
            )
            tgt = voxel_downsample(
                np.asarray(content[f"pcl_{a}"], np.float64)[:, :3], 1.0
            )
            self._lazy_memo(ck, icp_register(
                src, tgt, np.eye(4), voxel=1.0, max_corr_dist=1.5
            ))
        return self._lazy_cache[ck]

    def _content_key(self, content: dict) -> str:
        """Stable memo key for a sample dict: its stamped name (see
        _load_content). Falls back to id() only for contents that never
        passed through _load_content (hand-built fixtures)."""
        return str(content.get("name", id(content)))

    def _lazy_memo(self, key: tuple, value):
        self._lazy_cache[key] = value
        while len(self._lazy_cache) > self._lazy_cache_max:
            self._lazy_cache.popitem(last=False)

    def _ground_mask(self, content: dict, tk: str, pcl: np.ndarray):
        key = f"is_ground_{tk}"
        if key in content and content[key] is not None:
            return np.asarray(content[key], bool)
        if self.cfg.ground_label_source == "jcp":
            # reference lazy path: full JCP segmentation computed on first
            # access (waymo_torch_dataset.py:295-335), memoized
            ck = (self._content_key(content), "ground", tk)
            if ck not in self._lazy_cache:
                from liso_tpu_torch.data.ground import jpc_ground_remove

                self._lazy_memo(ck, jpc_ground_remove(pcl))
            return self._lazy_cache[ck]
        return infer_ground_label_using_cone(
            pcl, self.cfg.ground_cone_z_threshold_m
        )

    def build_frame(self, content: dict, tk: str):
        """The three views of torch_dataset_commons.py:1061-1106, padded.
        Returns (HostFrame, keep_mask_for_cropped_view)."""
        pcl = np.asarray(content[f"pcl_{tk}"], np.float32)
        if not self.cfg.use_lidar_intensity and pcl.shape[-1] == 4:
            pcl = np.concatenate([pcl[:, :3], np.zeros_like(pcl[:, :1])], -1)
        if pcl.shape[-1] == 3:
            pcl = np.concatenate([pcl, np.zeros_like(pcl[:, :1])], -1)
        is_ground = self._ground_mask(content, tk, pcl)
        rows = np.asarray(
            content.get(f"lidar_rows_{tk}", np.zeros(len(pcl), np.int32))
        )

        half = np.asarray(
            [self.cfg.bev.bev_range_m[0] * 0.5, self.cfg.bev.bev_range_m[1] * 0.5]
        )
        in_bev = np.all(np.abs(pcl[:, :2]) < half, axis=-1)
        zlo, zhi = self.cfg.pillar_height_range_m
        in_height = (zlo < pcl[:, 2]) & (pcl[:, 2] < zhi)
        keep = ~is_ground & in_bev & in_height

        cropped, valid = pad_to(pcl[keep], self.cfg.n_max)
        rows_c, _ = pad_to(rows[keep].astype(np.int32), self.cfg.n_max)
        full, full_valid = pad_to(pcl, self.cfg.m_max)
        ground_full, _ = pad_to(is_ground.astype(bool), self.cfg.m_max)
        return (
            HostFrame(
                pcl=cropped,
                valid=valid,
                rows=rows_c,
                pcl_full=full,
                full_valid=full_valid,
                is_ground_full=ground_full.astype(bool),
            ),
            keep,
        )

    def _gt_flow(self, content, a, b, pcl, keep):
        """Real GT object flow when the ETL precomputed it (KITTI tracking
        writes top-level flow_{a}_{b} from annotated box motion,
        create_kitti_tracking.py), else rigid ego flow for static scenes."""
        key = f"flow_{a}_{b}"
        if key in content:
            return np.asarray(content[key], np.float32)[keep]
        gt = content.get("gt", {})
        if isinstance(gt, dict) and key in gt:
            return np.asarray(gt[key], np.float32)[keep]
        odom = self._odom(content, a, b)
        inv = np.linalg.inv(odom)
        p = pcl[:, :3].astype(np.float64)
        return ((p @ inv[:3, :3].T + inv[:3, 3]) - p).astype(np.float32)

    def _slim_flow(self, fname: Path, pcl: np.ndarray, a: str, b: str):
        """Gather per-point flow from an exported SLIM npz BEV grid
        (torch_dataset_commons.py:590-675)."""
        p = self.pred_flow_path / (Path(fname).stem + ".npz")
        if not p.exists():
            return None
        pred = np.load(p, allow_pickle=True)
        bev_flow = np.asarray(pred[f"bev_raw_flow_{a}_{b}"])
        rng_m = np.asarray(pred["bev_range_m"], np.float32)
        bev_flow = expand_valid_bev_flow_to_zero_flow_neighbors(bev_flow)
        h, w = bev_flow.shape[:2]
        res = rng_m / np.array([h, w])
        rc = np.floor((pcl[:, :2] + 0.5 * rng_m) / res).astype(np.int64)
        in_range = (
            (rc[:, 0] >= 0) & (rc[:, 0] < h) & (rc[:, 1] >= 0) & (rc[:, 1] < w)
        )
        flow2d = np.zeros((len(pcl), 2), np.float32)
        flow2d[in_range] = bev_flow[rc[in_range, 0], rc[in_range, 1]]
        if in_range.any():
            flow2d[~in_range] = flow2d[in_range].mean(axis=0)
        return np.concatenate([flow2d, np.zeros_like(flow2d[:, :1])], -1)

    def _mined_boxes(self, sample_id: str):
        """torch_dataset_commons.py:559-588: confidence filter, probs->1."""
        if self.mined_boxes_db is None or sample_id not in self.mined_boxes_db:
            return None
        raw = self.mined_boxes_db[sample_id]["raw_box"]
        conf = np.squeeze(np.asarray(raw["probs"]), -1)
        keep = conf >= self.cfg.mined_confidence_threshold
        boxes = {k: np.asarray(v)[keep].astype(np.float32) for k, v in raw.items()}
        boxes["probs"] = np.ones_like(boxes["probs"])
        return boxes

    # -- main -----------------------------------------------------------
    def _load_content(self, idx: int) -> dict:
        """load_sample_dict + stamp a stable 'name' (from sample_files)
        so lazy-ICP/ground memo keys never fall back to id(content)."""
        content = self.load_sample_dict(idx)
        content.setdefault("name", Path(self.sample_files[idx]).stem)
        return content

    def get_pair(self, idx: int, a: str, b: str) -> HostSample:
        """Build the sample for a specific time-key pair (used by the SLIM
        flow export, which writes all 6 ordered pairs of t0/t1/t2)."""
        dt = self.cfg.time_delta_s * abs(int(b[1]) - int(a[1]))
        return self._build(self._load_content(idx), idx, a, b, dt)

    def __getitem__(self, idx: int) -> HostSample:
        content = self._load_content(idx)
        a, b, dt = self.select_time_keys(self.index_rng(idx, salt=1))
        return self._build(content, idx, a, b, dt)

    def _build(self, content: dict, idx: int, a: str, b: str, dt: float) -> HostSample:
        sample_id = str(content.get("name", Path(self.sample_files[idx]).stem))

        if self.augmentation is not None:
            content = self.augmentation(content, self.index_rng(idx))

        frame_a, keep_a = self.build_frame(content, a)
        frame_b, keep_b = self.build_frame(content, b)
        odom_ab = self._odom(content, a, b).astype(np.float32)
        odom_ba = np.linalg.inv(odom_ab).astype(np.float32)

        pcl_a_kept = np.asarray(content[f"pcl_{a}"], np.float32)[keep_a]
        pcl_b_kept = np.asarray(content[f"pcl_{b}"], np.float32)[keep_b]
        if self.cfg.flow_source == "gt" or self.pred_flow_path is None:
            fl_ab = self._gt_flow(content, a, b, pcl_a_kept, keep_a)
            fl_ba = self._gt_flow(content, b, a, pcl_b_kept, keep_b)
        else:
            fl_ab = self._slim_flow(self.sample_files[idx], pcl_a_kept, a, b)
            fl_ba = self._slim_flow(self.sample_files[idx], pcl_b_kept, b, a)
            if fl_ab is None:
                fl_ab = self._gt_flow(content, a, b, pcl_a_kept, keep_a)
            if fl_ba is None:
                fl_ba = self._gt_flow(content, b, a, pcl_b_kept, keep_b)
        flow_ab, _ = pad_to(fl_ab.astype(np.float32), self.cfg.n_max)
        flow_ba, _ = pad_to(fl_ba.astype(np.float32), self.cfg.n_max)

        # GT flow + per-point moving mask for the eval flow metrics
        gt_fl = self._gt_flow(content, a, b, pcl_a_kept, keep_a)
        gt_flow_ab, _ = pad_to(gt_fl.astype(np.float32), self.cfg.n_max)
        mm_key = f"moving_mask_{a}"
        gt_dict = content.get("gt", {})
        if isinstance(gt_dict, dict) and mm_key in gt_dict:
            mm = np.asarray(gt_dict[mm_key], bool)[keep_a]
        else:
            # derived: GT flow deviates from the rigid ego flow
            odom_ba_f = np.linalg.inv(self._odom(content, a, b))
            p = pcl_a_kept[:, :3].astype(np.float64)
            rigid = (p @ odom_ba_f[:3, :3].T + odom_ba_f[:3, 3]) - p
            mm = np.linalg.norm(gt_fl - rigid, axis=-1) > 0.05
        gt_moving, _ = pad_to(mm.astype(bool), self.cfg.n_max)

        gt_boxes = self.extract_gt_boxes(content, a)
        if gt_boxes is not None:
            gt_boxes = pad_boxes(gt_boxes, self.cfg.k_max_boxes)
        mined = self._mined_boxes(sample_id)
        target = (
            pad_boxes(mined, self.cfg.k_max_boxes)
            if mined is not None
            else gt_boxes
        )

        return HostSample(
            sample_id=sample_id,
            frame_t0=frame_a,
            frame_t1=frame_b,
            odom_t0_t1=odom_ab,
            odom_t1_t0=odom_ba,
            flow_t0_t1=flow_ab,
            flow_t1_t0=flow_ba,
            time_delta_s=dt,
            gt_boxes=gt_boxes,
            target_boxes=target,
            gt_flow_t0_t1=gt_flow_ab,
            gt_moving_mask=gt_moving,
        )


def collate(samples: List[HostSample]) -> Dict[str, np.ndarray]:
    """Stack HostSamples into batched arrays (device-ready)."""
    def stack(get):
        return np.stack([get(s) for s in samples])

    out = {
        "sample_id": [s.sample_id for s in samples],
        "pcl_t0": stack(lambda s: s.frame_t0.pcl),
        "valid_t0": stack(lambda s: s.frame_t0.valid),
        "rows_t0": stack(lambda s: s.frame_t0.rows),
        "pcl_t1": stack(lambda s: s.frame_t1.pcl),
        "valid_t1": stack(lambda s: s.frame_t1.valid),
        "odom_t0_t1": stack(lambda s: s.odom_t0_t1),
        "odom_t1_t0": stack(lambda s: s.odom_t1_t0),
        "flow_t0_t1": stack(lambda s: s.flow_t0_t1),
        "flow_t1_t0": stack(lambda s: s.flow_t1_t0),
        "time_delta_s": np.asarray([s.time_delta_s for s in samples], np.float32),
        # full-with-ground t0 cloud: consumed by the KITTI annotated-FoV
        # prediction filter in run_val (eval_ours.py:386-402) and by the
        # mining min-points check
        "pcl_full_w_ground": stack(lambda s: s.frame_t0.pcl_full),
        "pcl_full_valid": stack(lambda s: s.frame_t0.full_valid),
    }
    if samples[0].gt_flow_t0_t1 is not None:
        out["gt_flow_t0_t1"] = stack(lambda s: s.gt_flow_t0_t1)
        out["gt_moving_mask"] = stack(lambda s: s.gt_moving_mask)
    if samples[0].gt_boxes is not None:
        out["gt_boxes"] = {
            k: stack(lambda s: s.gt_boxes[k]) for k in samples[0].gt_boxes
        }
    if samples[0].target_boxes is not None:
        out["target_boxes"] = {
            k: stack(lambda s: s.target_boxes[k]) for k in samples[0].target_boxes
        }
    return out
