"""Kernel K1's plain version (liso_tpu_torch/ops/grid_scatter.py) vs
liso_tpu's grid_reduce_with_occ(op="max") in Pallas interpret mode and vs
jax.ops.segment_max: bitwise equal in fp32. The CUDA kernel itself is held
to this plain version on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.ops.grid_scatter_pallas import grid_reduce_with_occ
from liso_tpu_torch.ops.grid_scatter import grid_scatter_max_occ
from torch_grid_layouts import cell_layout

torch.set_num_threads(1)
I32MAX = np.iinfo(np.int32).max


def _case(name):
    rng = np.random.RandomState(11)
    b, n, nc, c = 2, 1024, 2048, 16
    cells = rng.randint(0, nc + 1, (b, n)).astype(np.int32)
    feats = rng.randn(b, n, c).astype(np.float32)  # signed features
    if name == "drop_and_pad":
        cells[cells >= nc] = I32MAX
        cells[:, :64] = nc  # drop bucket and int32-max pad together
    elif name == "all_dropped":
        cells[1, :] = I32MAX
    elif name == "non_tile_divisible":
        nc = 1000  # not a multiple of the TPU kernel's 1024-cell tile
        cells = rng.randint(0, nc + 40, (b, n)).astype(np.int32)
    elif name == "ties":
        feats = np.round(feats * 2) / 2  # many exact ties, incl. +-0
        cells = rng.randint(0, 64, (b, n)).astype(np.int32)
    elif name == "negative_only":
        feats = -np.abs(feats) - 1.0  # a cell's max must stay negative
    cells = np.sort(cells, axis=-1)
    return feats, cells, nc


CASES = ["signed", "drop_and_pad", "all_dropped", "non_tile_divisible",
         "ties", "negative_only"]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_pallas_interpret(name):
    feats, cells, nc = _case(name)
    want_g, want_o = grid_reduce_with_occ(
        jnp.asarray(feats), jnp.asarray(cells), nc, "max", True
    )
    got_g, got_o = grid_scatter_max_occ(
        torch.from_numpy(feats), torch.from_numpy(cells), nc
    )
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_segment_max(name):
    feats, cells, nc = _case(name)
    safe = np.minimum(cells, nc)
    seg = jax.vmap(
        lambda f, c: jax.ops.segment_max(f, c, num_segments=nc + 1)[:nc]
    )(jnp.asarray(feats), jnp.asarray(safe))
    want = np.where(np.isfinite(np.asarray(seg)), np.asarray(seg), 0.0)
    cnt = np.stack([np.bincount(s, minlength=nc + 1)[:nc] for s in safe])
    got_g, got_o = grid_scatter_max_occ(
        torch.from_numpy(feats), torch.from_numpy(cells), nc
    )
    np.testing.assert_array_equal(got_g.numpy(), want)
    np.testing.assert_array_equal(got_o[..., 0].numpy(), (cnt > 0).astype(np.float32))


# The edge layouts the card tests hold the CUDA kernel to
# (tests/torch_grid_layouts.py), pinned here to the TPU function: cell
# counts that are not a multiple of the 1024-cell tile, a run across a tile
# edge, the first and last cells, N below the tile, C = 4 and 12.
EDGE_CASES = [
    ("one_cell", 2, 2048, 2048, 16),
    ("tile_edge", 2, 1024, 2048, 16),
    ("uniform", 2, 1024, 2500, 12),
    ("end_cells", 2, 1024, 2500, 4),
    ("all_dropped", 2, 512, 1024, 8),
    ("uniform", 1, 100, 128 * 128, 4),
    ("skewed", 2, 2048, 128 * 128, 16),
]


@pytest.mark.parametrize("layout,b,n,nc,c", EDGE_CASES)
def test_plain_matches_pallas_interpret_edge_layouts(layout, b, n, nc, c):
    rng = np.random.RandomState(n + nc + c)
    cells = cell_layout(layout, rng, b, n, nc)
    feats = rng.randn(b, n, c).astype(np.float32)
    want_g, want_o = grid_reduce_with_occ(
        jnp.asarray(feats), jnp.asarray(cells), nc, "max", True
    )
    got_g, got_o = grid_scatter_max_occ(
        torch.from_numpy(feats), torch.from_numpy(cells), nc
    )
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    occupied = int(got_o.sum())
    if layout == "one_cell":
        assert occupied == b
    if layout == "all_dropped":
        assert int(got_o[-1].sum()) == 0 and int(got_o[0].sum()) > 0
