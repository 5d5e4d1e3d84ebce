"""Edge layouts of sorted cell (or bin) ids for the scatter kernels' tests.

numpy only, so that the card-only tests (tests/test_torch_cuda_kernels.py)
and the CPU tests against the Pallas kernels (tests/test_torch_grid_
scatter.py, tests/test_torch_grid_grads.py) draw the same layouts. The CUDA
kernel K1 gives each block a tile of TILE cells, K3 each cluster of 8 blocks
16 tiles, and each finds its points inside the kernel; these layouts put
points where that can go wrong.
"""
import numpy as np

IMAX = np.iinfo(np.int32).max
TILE = 1024  # cells per block of K1 (and the TPU kernel's tile)

LAYOUTS = ("uniform", "one_cell", "tile_edge", "end_cells", "all_dropped",
           "skewed", "crowded")


def cell_layout(name: str, rng: np.random.RandomState, b: int, n: int,
                nc: int) -> np.ndarray:
    """[b, n] int32 ids, ascending per sample. About a tenth of the points
    of "uniform" and "end_cells" are dropped, half of them with id nc and
    half with int32 max, as the pillar front end and the histogram drop
    them; the other layouts drop only where their name says.
      uniform     - ids uniform over the grid (with a drop share);
      one_cell    - every point of each sample in one cell;
      tile_edge   - a run of occupied cells across the first tile edge
                    (nc must exceed TILE + 40);
      end_cells   - cells 0 and nc - 1 only (first and last tile);
      all_dropped - as uniform, but the last sample has no point in the grid;
      skewed      - every point in at most 8 cells, plus a few drops;
      crowded     - ids normal around nc / 2 with a spread of nc / 250,
                    plus a few drops: tens to hundreds of points a cell
                    over a few tiles, as in the SLIM train step's threshold
                    histogram when the dynamicness crowds near 0.5.
    """
    if name in ("uniform", "all_dropped"):
        cells = rng.randint(0, nc + nc // 9 + 1, (b, n))
    elif name == "one_cell":
        cells = np.repeat(rng.randint(0, nc, (b, 1)), n, 1)
    elif name == "tile_edge":
        assert nc > TILE + 40, nc
        cells = rng.randint(TILE - 40, TILE + 40, (b, n))
    elif name == "end_cells":
        cells = np.where(rng.rand(b, n) < 0.5, 0, nc - 1)
        cells[rng.rand(b, n) < 0.1] = nc
    elif name == "skewed":
        hot = rng.randint(0, nc, 8)
        cells = hot[rng.randint(0, 8, (b, n))]
        cells[:, -7:] = nc
    elif name == "crowded":
        cells = (nc * (0.5 + 0.004 * rng.randn(b, n))).astype(np.int64)
        cells = cells.clip(0, nc - 1)
        cells[:, -7:] = nc
    else:
        raise ValueError(name)
    cells = cells.astype(np.int64)
    if name == "all_dropped":
        cells[-1] = nc
    drop = cells >= nc
    cells[drop] = np.where(rng.rand(int(drop.sum())) < 0.5, nc, IMAX)
    return np.sort(cells, -1).astype(np.int32)
