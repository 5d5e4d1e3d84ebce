"""The dataset ETL in the port (liso_tpu_torch/data/create_{kitti,
kitti_tracking,kitti_object,nuscenes,waymo,av2}.py, copies that import the
port's ground removal and ICP) against the JAX package's converters: each
converter's command-line entry runs in both packages on the same source
files (the fixture writers of tests/test_etl.py and
tests/test_etl_kitti_fixture.py) into two directories. The written file
names must match and every npy dict must be bitwise equal in keys, dtypes
and values, with the ICP odometry where the converter computes one. Then
the port's reader loads the port's output and gives, bitwise, what the JAX
reader gives on the JAX output.
"""
import importlib
from pathlib import Path

import numpy as np
import pytest

from liso_tpu.data import dataset as j_dataset
from liso_tpu.data import kitti as j_kitti
from liso_tpu.data import nuscenes as j_nuscenes
from liso_tpu.data import waymo as j_waymo
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu_torch.data import dataset as t_dataset
from liso_tpu_torch.data import kitti as t_kitti
from liso_tpu_torch.data import nuscenes as t_nuscenes
from liso_tpu_torch.data import waymo as t_waymo
from liso_tpu_torch.ops.bev import BevSetup as TBev
import test_etl as fx
from test_etl_kitti_fixture import write_kitti_raw_fixture
from test_torch_data import assert_same


def _source(family: str, root: Path):
    """Write the family's source files under `root`; returns the
    converter's argv (without --target_dir and the ICP flag)."""
    if family == "kitti_raw":
        return ["--kitti_raw_root", str(write_kitti_raw_fixture(root))]
    if family == "kitti_tracking":
        r = fx.TestKittiTrackingCreate()._make_tracking_root(root / "training")
        return ["--kitti_tracking_root", str(r)]
    if family == "kitti_object":
        r = fx.TestKittiObjectCreate()._make_object_root(root / "kitti_object")
        return ["--kitti_object_root", str(r)]
    if family == "nuscenes":
        r = fx.TestNuscenesCreate()._make_mini_nusc(root / "nusc")
        return ["--nusc_root", str(r), "--version", "v1.0-mini"]
    if family == "waymo":
        r = fx.TestWaymoCreate()._make_processed(root / "processed")
        return ["--processed_root", str(r)]
    pytest.importorskip("pyarrow")
    fx.TestAV2Create()._make_log(root / "av2_src")
    return ["--av2_root", str(root / "av2_src")]


def _icp_flag(family: str, icp: bool):
    if family == "av2":
        return [] if icp else ["--no-icp"]
    return ["--use_icp"] if icp else []


CASES = [("kitti_raw", False), ("kitti_raw", True),
         ("kitti_tracking", False), ("kitti_tracking", True),
         ("kitti_object", False), ("nuscenes", False), ("nuscenes", True),
         ("waymo", False), ("waymo", True), ("av2", False), ("av2", True)]


def _assert_equal(a, b, path):
    """Bitwise equality of what np.save wrote: arrays by dtype, shape and
    value (NaN equal to NaN), dicts, lists and tuples element-wise,
    everything else by type and ==."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == object:
            _assert_equal(list(a.ravel()), list(b.ravel()), path)
        else:
            assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), path
    else:
        assert type(a) is type(b) and a == b, path


def _convert(pkg: str, family: str, argv, target: Path):
    name = "kitti" if family == "kitti_raw" else family
    mod = importlib.import_module(f"{pkg}.data.create_{name}")
    mod.main(argv + ["--target_dir", str(target)])


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """{(family, icp): (jax output dir, port output dir)}, each converter
    run once per case."""
    out = {}
    for family, icp in CASES:
        root = tmp_path_factory.mktemp(f"{family}_{int(icp)}")
        try:
            argv = _source(family, root / "src") + _icp_flag(family, icp)
        except pytest.skip.Exception:
            out[(family, icp)] = None
            continue
        _convert("liso_tpu", family, argv, root / "jax")
        _convert("liso_tpu_torch", family, argv, root / "port")
        out[(family, icp)] = (root / "jax", root / "port")
    return out


@pytest.mark.parametrize("family,icp", CASES)
def test_converter_writes_what_jax_writes(converted, family, icp):
    dirs = converted[(family, icp)]
    if dirs is None:
        pytest.skip("pyarrow is not installed")
    jdir, tdir = dirs
    def files(d):
        return sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())

    jfiles = files(jdir)
    assert jfiles == files(tdir) and jfiles
    for rel in jfiles:
        if rel.suffix == ".npy":
            a = np.load(jdir / rel, allow_pickle=True)
            b = np.load(tdir / rel, allow_pickle=True)
            if a.dtype == object and a.shape == ():
                a, b = a.item(), b.item()
            _assert_equal(a, b, str(rel))
        else:
            assert (jdir / rel).read_bytes() == (tdir / rel).read_bytes(), rel
    if icp:
        d = np.load(next(tdir.rglob("*.npy")), allow_pickle=True).item()
        assert any(k.startswith("kiss_odom") for k in d)


def _readers(family):
    """(JAX reader class, port reader class, extra kwargs, DataCfg kwargs)."""
    if family == "kitti_raw":
        return j_kitti.KittiRawDataset, t_kitti.KittiRawDataset, {}, {}
    if family == "kitti_tracking":
        return (j_kitti.KittiTrackingDataset, t_kitti.KittiTrackingDataset,
                {}, {})
    if family == "kitti_object":
        return (j_kitti.KittiObjectDataset, t_kitti.KittiObjectDataset,
                {"split": "val"}, {})
    if family == "nuscenes":
        return (j_nuscenes.NuscenesDataset, t_nuscenes.NuscenesDataset, {},
                {})
    if family == "waymo":
        return (j_waymo.WaymoDataset, t_waymo.WaymoDataset,
                {"downsample_factor": 1},
                {"pillar_height_range_m": (-3.5, 1.0),
                 "ground_cone_z_threshold_m": -1.55})
    return j_waymo.AV2Dataset, t_waymo.AV2Dataset, {}, {}


@pytest.mark.parametrize("family,icp", [c for c in CASES if c[1]
                                        or c[0] == "kitti_object"])
def test_port_reader_loads_the_ports_output(converted, family, icp):
    dirs = converted[(family, icp)]
    if dirs is None:
        pytest.skip("pyarrow is not installed")
    jdir, tdir = dirs
    jcls, tcls, kw, cfg_kw = _readers(family)
    base = dict(n_max=4096, m_max=12288, use_skip_frames="never", **cfg_kw)
    jds = jcls(j_dataset.DataCfg(bev=JBev((60.0, 60.0), (64, 64)), **base),
               jdir, **kw)
    tds = tcls(t_dataset.DataCfg(bev=TBev((60.0, 60.0), (64, 64)), **base),
               tdir, **kw)
    assert len(tds) == len(jds) > 0
    for i in range(len(tds)):
        assert_same(tds[i], jds[i], f"{family}[{i}]")
    assert tds[0].frame_t0.valid.any()


def test_create_nuscenes_entry(tmp_path):
    """data/nuscenes.create_nuscenes, the ETL entry of the dataset module,
    writes what the JAX package's entry writes."""
    root = fx.TestNuscenesCreate()._make_mini_nusc(tmp_path / "nusc")
    j_nuscenes.create_nuscenes(root, tmp_path / "jax", version="v1.0-mini")
    t_nuscenes.create_nuscenes(root, tmp_path / "port", version="v1.0-mini")
    jf = sorted(p.name for p in (tmp_path / "jax").rglob("*.npy"))
    assert jf == sorted(p.name for p in (tmp_path / "port").rglob("*.npy"))
    assert jf
    for name in jf:
        a = np.load(next((tmp_path / "jax").rglob(name)), allow_pickle=True)
        b = np.load(next((tmp_path / "port").rglob(name)), allow_pickle=True)
        _assert_equal(a.item(), b.item(), name)
