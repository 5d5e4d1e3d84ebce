"""The port's copy of data/augmentation.py against the JAX package's
(numpy on both sides): from the same RandomState seed every output must
agree bitwise, and each side must leave its RandomState in the same state
(the same draws, in the same order) — copy-paste with and without raydrop,
an empty augmentation DB, a DB whose boxes are all under min_box_len, and
the global SE(2) augment_sample_content."""
import numpy as np
import pytest
import torch

from liso_tpu.data import augmentation as jaug
from liso_tpu_torch.data import augmentation as taug
from test_torch_data import assert_same as _assert_same

torch.set_num_threads(1)
BEV_RANGE = (40.0, 40.0)


def assert_same(a, b, path="out"):
    """Bitwise equality of nested dicts, tuples and lists of numpy arrays:
    arrays by dtype, shape and value (NaN equal to NaN), the rest by ==."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        _assert_same(a, b, path)
    else:
        assert type(a) is type(b) and a == b, path


def augm_db(seed: int, n: int = 12, short: bool = False) -> dict:
    """A finalized augmentation DB (tracker/dbs.finalize_augm_db's layout):
    snippets of 3-60 points in box coordinates with 3-40 lidar rows, boxes
    of 1.5-5 m length (short=True: all under min_box_len) within 18 m of the
    sensor."""
    rng = np.random.RandomState(seed)
    dims = np.stack([rng.uniform(1.5, 5.0, n), rng.uniform(1.0, 2.5, n),
                     rng.uniform(1.2, 2.0, n)], -1).astype(np.float32)
    if short:
        dims[:, 0] = rng.uniform(0.5, 2.4, n)
    pcl, rows = [], []
    for i in range(n):
        m = rng.randint(3, 61)
        p = (rng.uniform(-0.5, 0.5, (m, 3)) * dims[i]).astype(np.float32)
        pcl.append(np.concatenate([p, rng.uniform(0, 1, (m, 1))], -1)
                   .astype(np.float32))
        rows.append(rng.randint(0, rng.randint(3, 41), m).astype(np.int64))
    r = rng.uniform(4.0, 18.0, n)
    phi = rng.uniform(-np.pi, np.pi, n)
    pos = np.stack([r * np.cos(phi), r * np.sin(phi), rng.uniform(-1, 0, n)],
                   -1).astype(np.float32)
    return {
        "pcl_in_box_cosy": pcl,
        "lidar_rows": rows,
        "boxes": {
            "pos": pos, "dims": dims,
            "rot": rng.uniform(-np.pi, np.pi, (n, 1)).astype(np.float32),
            "probs": rng.uniform(0.3, 1.0, (n, 1)).astype(np.float32),
            "velo": rng.uniform(0, 3, (n, 1)).astype(np.float32),
        },
        "box_T_sensor": np.tile(np.eye(4), (n, 1, 1)),
        "unique_track_id": np.arange(n, dtype=np.int64),
    }


def base_cloud(seed: int, n: int = 30):
    """A sparse cloud (uniform in the BEV range, so that boxes find free
    space) and its lidar rows."""
    rng = np.random.RandomState(seed + 100)
    pcl = np.concatenate([rng.uniform(-19, 19, (n, 2)),
                          rng.uniform(-2, 1, (n, 1)), rng.uniform(0, 1, (n, 1))],
                         -1).astype(np.float32)
    return pcl, rng.randint(0, 64, n).astype(np.int64)


def assert_same_rng(a: np.random.RandomState, b: np.random.RandomState):
    sa, sb = a.get_state(), b.get_state()
    assert sa[0] == sb[0] and np.array_equal(sa[1], sb[1]) and sa[2:] == sb[2:]


def paste_both(db, seed, **cfg):
    pcl, rows = base_cloud(seed)
    jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
    want = jaug.paste_boxes_into_sample(pcl.copy(), rows.copy(), db, jr,
                                        BEV_RANGE, jaug.BoxAugmCfg(**cfg))
    got = taug.paste_boxes_into_sample(pcl.copy(), rows.copy(), db, tr,
                                       BEV_RANGE, taug.BoxAugmCfg(**cfg))
    assert_same_rng(tr, jr)
    return got, want, len(pcl)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("raydrop", [False, True])
def test_paste_boxes_bitwise(seed, raydrop):
    got, want, n_base = paste_both(augm_db(seed), seed,
                                   use_raydrop_augm=raydrop)
    assert_same(got, want)
    assert len(got[2]["pos"]) > 0 and len(got[0]) > n_base


def test_paste_boxes_empty_db():
    got, want, n_base = paste_both(augm_db(0, n=0), 5)
    assert_same(got, want)
    assert len(got[0]) == n_base and got[2]["pos"].shape == (0, 3)


def test_paste_boxes_under_min_box_len():
    got, want, n_base = paste_both(augm_db(7, short=True), 7,
                                   use_raydrop_augm=True)
    assert_same(got, want)
    assert len(got[0]) == n_base and got[2]["pos"].shape == (0, 3)


def test_paste_boxes_into_crowded_cloud():
    """Every placement is next to an occupied point: nothing pasted, the
    same draws consumed."""
    rng = np.random.RandomState(9)
    occupied = rng.uniform(-19, 19, (4000, 2)).astype(np.float32)
    db = augm_db(9)
    pcl, rows = base_cloud(9)
    jr, tr = np.random.RandomState(9), np.random.RandomState(9)
    want = jaug.paste_boxes_into_sample(pcl, rows, db, jr, BEV_RANGE,
                                        occupied_xy=occupied)
    got = taug.paste_boxes_into_sample(pcl, rows, db, tr, BEV_RANGE,
                                       occupied_xy=occupied)
    assert_same(got, want)
    assert_same_rng(tr, jr)
    assert got[2]["pos"].shape == (0, 3)


@pytest.mark.parametrize("seed", [0, 4])
def test_resolution_raydrop_bitwise(seed):
    pts = augm_db(seed)["pcl_in_box_cosy"][0] + np.float32(10.0)
    jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
    assert_same(taug.resolution_raydrop_augmentation(pts, tr),
                jaug.resolution_raydrop_augmentation(pts, jr))
    assert_same_rng(tr, jr)


def test_augment_sample_content_bitwise():
    rng = np.random.RandomState(3)
    odom = np.eye(4)
    odom[:2, 3] = [0.5, 0.1]
    content = {
        "pcl_t0": rng.uniform(-20, 20, (300, 4)).astype(np.float32),
        "pcl_t1": rng.uniform(-20, 20, (280, 4)).astype(np.float32),
        "odom_t0_t1": odom, "kiss_odom_t0_t1": odom.copy(),
        "name": "frame_0",
        "gt": {
            "flow_t0_t1": rng.normal(0, 1, (300, 3)).astype(np.float32),
            "boxes": {"pos": rng.uniform(-10, 10, (5, 3)).astype(np.float32),
                      "dims": rng.uniform(1, 4, (5, 3)).astype(np.float32),
                      "rot": rng.uniform(-3, 3, (5, 1)).astype(np.float32)},
        },
    }
    jr, tr = np.random.RandomState(11), np.random.RandomState(11)
    cfg = dict(max_rot_deg=45.0, max_sensor_pos_offset_m=3.0)
    want = jaug.augment_sample_content(content, jr, jaug.GlobalAugmCfg(**cfg))
    got = taug.augment_sample_content(content, tr, taug.GlobalAugmCfg(**cfg))
    assert_same(got, want)
    assert_same_rng(tr, jr)
    assert not np.array_equal(got["pcl_t0"], content["pcl_t0"])


def test_configs_are_the_same():
    assert taug.BoxAugmCfg()._asdict() == jaug.BoxAugmCfg()._asdict()
    assert taug.GlobalAugmCfg()._asdict() == jaug.GlobalAugmCfg()._asdict()
