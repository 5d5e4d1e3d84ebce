"""The functions of liso_tpu that no path of the JAX package calls outside
its tests, in the port under their JAX names, against JAX on seeded
inputs: ops/bev.{gather_bev_map_at_points, bilinear_sample_2d},
ops/pillars.{pillar_point_features, scatter_pillars_to_bev, occupancy_map},
ops/scatter.gather_grid, ops/knn.knn_gather, data/sample.{DetectionSample,
pad_points} and models/pillar_encoder.point_feature_mask.

Limits: gathers, masks and the padding bitwise; the segment means and the
interpolation sums within 1e-6 (their order of sums may differ: XLA's
segment_sum against index_add_)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from liso_tpu.data import sample as j_sample
from liso_tpu.models import pillar_encoder as j_pe
from liso_tpu.ops import bev as j_bev
from liso_tpu.ops import knn as j_knn
from liso_tpu.ops import pillars as j_pillars
from liso_tpu.ops import scatter as j_scatter
from liso_tpu_torch.data import sample as t_sample
from liso_tpu_torch.models import pillar_encoder as t_pe
from liso_tpu_torch.ops import bev as t_bev
from liso_tpu_torch.ops import knn as t_knn
from liso_tpu_torch.ops import pillars as t_pillars
from liso_tpu_torch.ops import scatter as t_scatter
from liso_tpu_torch.ops.boxes import Boxes

torch.set_num_threads(1)
SUM_TOL = 1e-6
BEV = ((40.0, 30.0), (32, 24))


def _t(x):
    return torch.from_numpy(np.array(x))


def _bitwise(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SUM_TOL,
                               atol=SUM_TOL)


def _points(seed, n=600, f=4):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-24, 24, (n, f)).astype(np.float32)
    pts[:, 2] = rng.uniform(-7, 7, n)  # some beyond the pillar cut-off
    return pts, rng.rand(n) > 0.1


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_bev_map_at_points(seed):
    rng = np.random.RandomState(seed)
    bev_map = rng.randn(32, 24, 5).astype(np.float32)
    pts = rng.uniform(-25, 25, (3, 40, 2)).astype(np.float32)
    _bitwise(t_bev.gather_bev_map_at_points(_t(bev_map), _t(pts),
                                            t_bev.BevSetup(*BEV)),
             j_bev.gather_bev_map_at_points(jnp.asarray(bev_map),
                                            jnp.asarray(pts),
                                            j_bev.BevSetup(*BEV)))


@pytest.mark.parametrize("seed", [2, 3])
def test_bilinear_sample_2d(seed):
    rng = np.random.RandomState(seed)
    img = rng.randn(17, 13, 3).astype(np.float32)
    coords = rng.uniform(-3, 20, (2, 50, 2)).astype(np.float32)
    coords[0, :4] = [[0, 0], [16, 12], [16.5, -1], [3, 7]]  # edges, integer
    _close(t_bev.bilinear_sample_2d(_t(img), _t(coords)),
           j_bev.bilinear_sample_2d(jnp.asarray(img), jnp.asarray(coords)))


@pytest.mark.parametrize("seed", [4, 5])
def test_pillar_features_scatter_and_occupancy(seed):
    pts, valid = _points(seed)
    jsetup, tsetup = j_bev.BevSetup(*BEV), t_bev.BevSetup(*BEV)
    jcell, jin = j_pillars.pillarize(jnp.asarray(pts), jnp.asarray(valid),
                                     jsetup)
    tcell, tin = t_pillars.pillarize(_t(pts), _t(valid), tsetup)
    _bitwise(tcell, jcell)
    _bitwise(tin, jin)
    jf = j_pillars.pillar_point_features(jnp.asarray(pts), jcell, jin, jsetup)
    tf = t_pillars.pillar_point_features(_t(pts), tcell, tin, tsetup)
    assert tf.shape == (len(pts), 9)
    _close(tf, jf)
    _bitwise(tf[:, :4], jf[:, :4])  # the raw features
    enc = np.random.RandomState(seed).randn(len(pts), 6).astype(np.float32)
    _bitwise(t_pillars.scatter_pillars_to_bev(_t(enc), tcell, tsetup),
             j_pillars.scatter_pillars_to_bev(jnp.asarray(enc), jcell, jsetup))
    occ = t_pillars.occupancy_map(tcell, tin, tsetup)
    _bitwise(occ, j_pillars.occupancy_map(jcell, jin, jsetup))
    assert 0 < float(occ.sum()) < 32 * 24


def test_gather_grid_clamps_the_drop_bucket():
    rng = np.random.RandomState(6)
    grid = rng.randn(50, 3).astype(np.float32)
    ids = np.array([0, 49, 50, 12, 50, -1], np.int32)  # 50: the drop bucket
    got = t_scatter.gather_grid(_t(grid), _t(ids))
    _bitwise(got, j_scatter.gather_grid(jnp.asarray(grid), jnp.asarray(ids)))
    _bitwise(got[2], grid[49])


def test_knn_gather():
    rng = np.random.RandomState(7)
    refs = rng.randn(30, 3).astype(np.float32)
    idx = rng.randint(0, 30, 64).astype(np.int32)
    _bitwise(t_knn.knn_gather(_t(refs), _t(idx)),
             j_knn.knn_gather(jnp.asarray(refs), jnp.asarray(idx)))


@pytest.mark.parametrize("n", [5, 64, 100])
def test_pad_points(n):
    pts = np.random.RandomState(n).randn(n, 4)  # float64 in, float32 out
    for a, b in zip(t_sample.pad_points(pts, 64), j_sample.pad_points(pts, 64)):
        assert a.dtype == b.dtype
        _bitwise(a, b)


def test_detection_sample():
    assert t_sample.DetectionSample._fields == j_sample.DetectionSample._fields
    pcl = t_sample.PointCloud(torch.zeros(1, 8, 4),
                              torch.ones(1, 8, dtype=torch.bool))
    s = t_sample.DetectionSample(pcl, Boxes.empty(2, batch=(1,)))
    assert s.centermaps is None and s.centermaps_ignore is None


@pytest.mark.parametrize("mask", [
    (True,) * 9,
    (True, True, True, False, True, True, True, False, False),
    (False, False, True, True, False, False, False, True, True)])
def test_point_feature_mask(mask):
    x = np.random.RandomState(8).randn(2, 10, 9).astype(np.float32)
    _bitwise(t_pe.point_feature_mask(_t(x), mask),
             j_pe.point_feature_mask(jnp.asarray(x), mask))
