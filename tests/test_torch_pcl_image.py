"""visu/pcl_image.py in the port (a copy of liso_tpu/visu/pcl_image.py)
against the JAX package's on seeded clouds: every function bitwise.
apply_cmap and plot_to_np_image run only where matplotlib is installed, as
in tests/test_visu_and_wrappers.py."""
import numpy as np
import pytest

from liso_tpu.visu import pcl_image as jp
from liso_tpu_torch.visu import pcl_image as tp


def _cloud(seed, n=3000):
    rng = np.random.RandomState(seed)
    pcl = rng.uniform(-40, 40, (n, 4)).astype(np.float32)
    pcl[:, 3] = rng.uniform(-2, 3, n)  # outside [0, 1]: normalised
    return pcl


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_pillarize_and_occupancy(seed):
    pcl = _cloud(seed)
    rng_m, res = np.array([60.0, 50.0]), np.array([64, 48])
    _same(tp.pillarize_pointcloud(pcl, rng_m, res),
          jp.pillarize_pointcloud(pcl, rng_m, res))
    _same(tp.create_occupancy_pcl_image(pcl, rng_m, res),
          jp.create_occupancy_pcl_image(pcl, rng_m, res))


@pytest.mark.parametrize("seed", [2, 3])
def test_projection_and_linear_index(seed):
    pcl = _cloud(seed)
    lo, hi, grid = np.array([-30.0, -20.0]), np.array([35.0, 25.0]), (96, 80)
    _same(tp.project_2d_pcl_to_rowcol_nonsquare_bev_range(pcl[:, :2], lo, hi,
                                                          grid),
          jp.project_2d_pcl_to_rowcol_nonsquare_bev_range(pcl[:, :2], lo, hi,
                                                          grid))
    for a, b in zip(tp.get_linear_bev_idx(pcl, lo, hi, grid),
                    jp.get_linear_bev_idx(pcl, lo, hi, grid)):
        _same(a, b)


@pytest.mark.parametrize("normalised", [False, True])
def test_topdown_image(normalised):
    pcl = _cloud(4)
    inten = pcl[:, 3] if not normalised else np.clip(pcl[:, 3], 0, 1)
    lo, hi, grid = np.array([-30.0, -30.0]), np.array([30.0, 30.0]), (64, 64)
    got = tp.create_topdown_f32_pcl_image_variable_extent(pcl, inten, lo, hi,
                                                          grid)
    want = jp.create_topdown_f32_pcl_image_variable_extent(pcl, inten, lo, hi,
                                                           grid)
    for a, b in zip(got, want):
        _same(a, b)
    assert got[1].any()


def test_limit_visu_image_batches():
    img = np.random.RandomState(5).rand(12, 4, 4, 3).astype(np.float32)
    for n in (3, 8, 12):
        _same(tp.limit_visu_image_batches(img[:n]),
              jp.limit_visu_image_batches(img[:n]))


def test_apply_cmap_and_plot():
    pytest.importorskip("matplotlib")
    x = np.linspace(-3, 5, 48).reshape(6, 8)
    _same(tp.apply_cmap(x), jp.apply_cmap(x))
    _same(tp.apply_cmap(x[..., None], input_has_channel_dim=True,
                        normalize=False),
          jp.apply_cmap(x[..., None], input_has_channel_dim=True,
                        normalize=False))
    _same(tp.apply_cmap(np.zeros((4, 4))), jp.apply_cmap(np.zeros((4, 4))))
    import matplotlib.pyplot as plt

    imgs = []
    for mod in (tp, jp):
        fig = plt.figure(figsize=(2, 2), dpi=20)
        plt.plot([0, 1], [1, 0])
        imgs.append(mod.plot_to_np_image(fig))
    _same(*imgs)
    assert imgs[0].shape == (40, 40, 3)
