"""The port's data layer (liso_tpu_torch.data) against the JAX package's
(liso_tpu.data): numpy on both sides, so every sample and batch must agree
bitwise — synthetic samples and collated batches, the Prefetcher's epochs
(threads and fork processes), the nuScenes / Waymo / AV2 / KITTI readers
over npy samples written here, SLIM-flow npz reads, and the lazy ICP
odometry and JCP ground fallbacks."""
import numpy as np
import pytest
import torch

from liso_tpu.data import dataset as j_dataset
from liso_tpu.data import kitti as j_kitti
from liso_tpu.data import nuscenes as j_nuscenes
from liso_tpu.data import synthetic as j_synthetic
from liso_tpu.data import waymo as j_waymo
from liso_tpu.data.pipeline import Prefetcher as JPrefetcher
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu_torch.data import dataset as t_dataset
from liso_tpu_torch.data import kitti as t_kitti
from liso_tpu_torch.data import nuscenes as t_nuscenes
from liso_tpu_torch.data import synthetic as t_synthetic
from liso_tpu_torch.data import waymo as t_waymo
from liso_tpu_torch.data.pipeline import Prefetcher as TPrefetcher
from liso_tpu_torch.ops.bev import BevSetup as TBev

torch.set_num_threads(1)
BEV = ((40.0, 40.0), (64, 64))


def cfgs(**kw):
    """The same DataCfg in each package: (jax, port)."""
    base = dict(n_max=2048, m_max=8192, **kw)
    return (j_dataset.DataCfg(bev=JBev(*BEV), **base),
            t_dataset.DataCfg(bev=TBev(*BEV), **base))


def assert_same(a, b, path="sample"):
    """Bitwise equality of samples or batches: arrays by dtype, shape and
    value (NaN equal to NaN), everything else by ==."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        assert type(a).__name__ == type(b).__name__ and a._fields == b._fields
        for f in a._fields:
            assert_same(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    else:
        assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize("skip", ["never", "only", "both"])
def test_synthetic_samples_and_batches_bitwise(skip):
    jc, tc = cfgs(use_skip_frames=skip)
    jd = j_synthetic.SyntheticDataset(jc, n_frames=5, seed=3, n_points=3000)
    td = t_synthetic.SyntheticDataset(tc, n_frames=5, seed=3, n_points=3000)
    for idx in (0, 2, 4):
        assert_same(jd[idx], td[idx])
        assert_same(jd.get_pair(idx, "t1", "t2"), td.get_pair(idx, "t1", "t2"))
    assert_same(j_dataset.collate([jd[1], jd[3]]),
                t_dataset.collate([td[1], td[3]]))


@pytest.mark.parametrize("use_processes", [False, True])
def test_prefetcher_epochs_bitwise(use_processes):
    """Shuffled epochs (seed 0) in the same order on both sides; the port's
    loader gives numpy batches without a device."""
    jc, tc = cfgs()
    jd = j_synthetic.SyntheticDataset(jc, n_frames=7, seed=1, n_points=2000)
    td = t_synthetic.SyntheticDataset(tc, n_frames=7, seed=1, n_points=2000)
    kw = dict(batch_size=2, shuffle=True, num_workers=2, seed=0,
              use_processes=use_processes)
    jl, tl = JPrefetcher(jd, **kw), TPrefetcher(td, **kw)
    try:
        for _ in range(2):
            jb, tb = list(jl), list(tl)
            assert len(jb) == len(tb) == 3
            for a, b in zip(jb, tb):
                assert_same(a, b, "batch")
    finally:
        tl.close()
        jl.pool.shutdown()


def test_prefetcher_device_batches_are_tensors():
    """With a device, every array of a batch arrives as a tensor on it,
    equal to the numpy batch."""
    _, tc = cfgs()
    td = t_synthetic.SyntheticDataset(tc, n_frames=3, seed=1, n_points=2000)
    kw = dict(batch_size=1, shuffle=False, num_workers=1)
    plain, dev = TPrefetcher(td, **kw), TPrefetcher(td, device="cpu", **kw)
    try:
        for a, b in zip(plain, dev):
            assert b["sample_id"] == a["sample_id"]
            for k, v in a.items():
                if isinstance(v, np.ndarray):
                    assert isinstance(b[k], torch.Tensor), k
                    assert np.array_equal(b[k].numpy(), v), k
    finally:
        plain.close()
        dev.close()


def test_prefetcher_raises_what_the_dataset_raises():
    _, tc = cfgs()
    td = t_synthetic.SyntheticDataset(tc, n_frames=4, seed=1, n_points=2000)

    def broken(idx):
        raise KeyError(f"no sample {idx}")

    td.load_sample_dict = broken
    loader = TPrefetcher(td, batch_size=2, num_workers=1)
    try:
        with pytest.raises(KeyError, match="no sample"):
            next(iter(loader))
    finally:
        loader.close()


def write_samples(d, names, category, tracks=False):
    """Synthetic npy samples in the shared ETL format with objects_t0 (and
    objects_t1 with track ids, for the KITTI tracking reader)."""
    d.mkdir(parents=True, exist_ok=True)
    seq = j_synthetic.SyntheticSequence(n_frames=len(names) + 2, seed=0,
                                        n_bg=3000)
    for t, name in enumerate(names):
        content = seq.sample_dict(t)
        content["name"] = name
        boxes = content["gt"]["boxes"]
        k = len(boxes["pos"])
        poses = np.tile(np.eye(4)[None], (k, 1, 1))
        poses[:, :3, 3] = boxes["pos"]
        cats = np.array([category] * (k - 1) + ["DontCare"])
        objects = {"poses": poses, "size": boxes["dims"], "category": cats}
        if tracks:
            objects["track_ids"] = np.arange(k)
            moved = dict(objects, poses=poses.copy())
            moved["poses"][:, 0, 3] += 0.7
            content["gt"]["objects_t1"] = moved
        content["gt"]["objects_t0"] = objects
        np.save(d / name, content)


READERS = {
    "nuscenes": (lambda m: m.NuscenesDataset, dict(mode="train"),
                 "nuscenes/train", ["scene-0001_0000", "scene-0001_0001",
                                    "scene-0002_0000"], "car"),
    "waymo": (lambda m: m.WaymoDataset, dict(downsample_factor=2), "waymo",
              [f"segment1_{t:04d}" for t in range(4)], "TYPE_VEHICLE"),
    "av2": (lambda m: m.AV2Dataset, {}, "av2/log_a", ["0000", "0001"],
            "REGULAR_VEHICLE"),
    "kitti_tracking": (lambda m: m.KittiTrackingDataset, {}, "kitti_tracking",
                       ["2011_09_26_0001_0000", "2011_09_26_0001_0001"], "Car"),
    "kitti_object": (lambda m: m.KittiObjectDataset, dict(split="val"),
                     "kitti_object_w_future_pcl/val", ["000000", "000001"],
                     "Car"),
    "kitti_raw": (lambda m: m.KittiRawDataset, {}, "kitti_raw",
                  ["2011_09_26_0001_0000", "2011_09_26_0002_0000"], "Car"),
}
MODULES = {"nuscenes": (j_nuscenes, t_nuscenes), "waymo": (j_waymo, t_waymo),
           "av2": (j_waymo, t_waymo)}


@pytest.mark.parametrize("family", sorted(READERS))
def test_readers_bitwise(tmp_path, family):
    get_cls, kw, sub, names, category = READERS[family]
    write_samples(tmp_path / sub, names, category,
                  tracks=family == "kitti_tracking")
    jm, tm = MODULES.get(family, (j_kitti, t_kitti))
    jc, tc = cfgs(use_skip_frames="both")
    jd, td = get_cls(jm)(jc, tmp_path, **kw), get_cls(tm)(tc, tmp_path, **kw)
    assert len(jd) == len(td) >= 1
    assert [str(f) for f in jd.sample_files] == [str(f) for f in td.sample_files]
    assert jd.num_sequences == td.num_sequences
    for s in range(jd.num_sequences):
        assert (jd.get_consecutive_sample_idxs_for_sequence(s)
                == td.get_consecutive_sample_idxs_for_sequence(s))
    for idx in range(len(jd)):
        assert_same(jd[idx], td[idx])
    if family not in ("kitti_raw",):
        assert td[0].gt_boxes is not None and td[0].gt_boxes["valid"].any()


def test_slim_flow_npz_read_bitwise(tmp_path):
    """flow_source slim: the same exported npz gives the same per-point
    flow (zero-flow-neighbour expansion, out-of-range fill) on both
    sides, and the flow differs from the GT flow it replaces."""
    rng = np.random.RandomState(4)
    h, w = BEV[1]
    arrays = {"bev_range_m": np.asarray(BEV[0]),
              "static_threshold": np.asarray(0.3, np.float32)}
    for a, b in (("t0", "t1"), ("t1", "t0"), ("t0", "t2"), ("t2", "t0")):
        grid = rng.normal(0, 1, (h, w, 2)).astype(np.float32)
        grid[rng.rand(h, w) < 0.6] = 0.0  # empty cells, some next to flow
        arrays[f"bev_raw_flow_{a}_{b}"] = grid
        arrays[f"bev_dynamicness_{a}_{b}"] = rng.rand(h, w).astype(np.float32)
    np.savez_compressed(tmp_path / "synth0_0001.npz", **arrays)
    jc, tc = cfgs(flow_source="slim", use_skip_frames="both")
    jd = j_synthetic.SyntheticDataset(jc, n_frames=3, seed=2, n_points=3000,
                                      pred_flow_path=tmp_path)
    td = t_synthetic.SyntheticDataset(tc, n_frames=3, seed=2, n_points=3000,
                                      pred_flow_path=tmp_path)
    for idx in range(3):  # sample 1 has an npz, 0 and 2 fall back to GT
        assert_same(jd[idx], td[idx])
    s = td.get_pair(1, "t0", "t1")
    assert not np.array_equal(s.flow_t0_t1, s.gt_flow_t0_t1)
    assert (s.flow_t0_t1[s.frame_t0.valid, 2] == 0).all()


def test_lazy_icp_odom_and_jcp_ground_fallbacks_bitwise():
    """Samples stored without odometry and ground labels: both packages
    register the scans (native ICP when built, else numpy) and run the JCP
    ground segmentation to the same arrays."""
    seq = j_synthetic.SyntheticSequence(n_frames=4, n_bg=3000, n_objects=0,
                                        ego_speed=0.8)

    def bare(base):
        class Bare(base):
            def __init__(self, cfg):
                super().__init__(cfg, sample_files=["s0"])

            def load_sample_dict(self, idx):
                c = seq.sample_dict(idx)
                return {k: v for k, v in c.items()
                        if not k.startswith(("odom_", "kiss_odom_",
                                             "is_ground_"))}
        return Bare

    jc, tc = cfgs(ground_label_source="jcp", use_skip_frames="never")
    jd, td = bare(j_dataset.LidarDataset)(jc), bare(t_dataset.LidarDataset)(tc)
    content = td.load_sample_dict(0)
    odom_j, odom_t = jd._odom(content, "t0", "t1"), td._odom(content, "t0", "t1")
    assert np.array_equal(odom_j, odom_t)
    true_odom = np.asarray(seq.sample_dict(0)["odom_t0_t1"])
    np.testing.assert_allclose(odom_t[:3, 3], true_odom[:3, 3], atol=0.15)
    pcl = np.asarray(content["pcl_t0"], np.float32)
    assert np.array_equal(jd._ground_mask(content, "t0", pcl),
                          td._ground_mask(content, "t0", pcl))
    assert_same(jd[0], td[0])
    assert {k[1] for k in td._lazy_cache} == {"odom", "ground"}
