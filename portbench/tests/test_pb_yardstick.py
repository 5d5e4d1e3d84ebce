"""The operation and byte counters agree with counts by hand."""
import torch
from torch import nn

from portbench import yardstick


def _count(module, x):
    with yardstick.count_flops(module) as f:
        module(x)
    return f["flops"]


def test_conv_counts():
    conv = nn.Conv2d(3, 8, 3, padding=1, device="meta")
    assert _count(conv, torch.empty(2, 3, 16, 16, device="meta")) == \
        2 * (2 * 8 * 16 * 16) * (3 * 9)
    grouped = nn.Conv2d(4, 8, 3, padding=1, groups=2, device="meta")
    assert _count(grouped, torch.empty(1, 4, 5, 5, device="meta")) == \
        2 * (8 * 25) * (2 * 9)


def test_transposed_and_linear_counts():
    up = nn.ConvTranspose2d(6, 4, 2, stride=2, device="meta")
    assert _count(up, torch.empty(1, 6, 3, 3, device="meta")) == \
        2 * (6 * 9) * (4 * 4)
    lin = nn.Linear(9, 64, bias=False, device="meta")
    assert _count(lin, torch.empty(2, 100, 9, device="meta")) == \
        2 * 200 * 64 * 9


def test_kernel_costs():
    feats = torch.zeros(2, 100, 8)
    # sorted cell ids: 60 points inside the 50-cell grid over 7 cells, the
    # rest in the drop bucket
    cells = torch.full((2, 100), 50, dtype=torch.int32)
    cells[0, :40] = torch.tensor([1] * 10 + [2] * 10 + [7] * 20)
    cells[1, :20] = torch.tensor([0] * 5 + [3] * 5 + [4] * 5 + [49] * 5)
    grid, occ = torch.zeros(2, 50, 8), torch.zeros(2, 50, 1)
    nbytes, nops = yardstick.scatter_max_cost(feats, cells, 50, (grid, occ))()
    assert nbytes == 4 * (200 + 800 + 100) + 4 * 60 * 8 and nops == 60 * 8
    dfeats = torch.zeros(2, 100, 8)
    nbytes, nops = yardstick.scatter_max_vjp_cost(feats, cells, grid, grid,
                                                  dfeats)()
    assert nbytes == 4 * (200 + 1600) + 4 * (60 + 2 * 7) * 8
    assert nops == 2 * 60 * 8
    f0 = torch.zeros(1, 64, 16, dtype=torch.bfloat16)
    f1 = torch.zeros(1, 96, 16, dtype=torch.bfloat16)
    coords = torch.zeros(1, 2, 64)
    out = torch.zeros(1, 4 * 64, 64)
    nbytes, nops = yardstick.corr_window_cost(f0, f1, coords, None, 3, out)()
    assert nbytes == 2 * 1024 + 2 * 1536 + 4 * 128 + 4 * 16384
    assert nops == 2 * 64 * 16 * 256
    assert yardstick.corr_lookup_flops(1, 64, 16, 4, 3) == 2 * 64 * 4 * 64 * 16


def test_least_time():
    assert yardstick.least_seconds(3.35e12, 0, "fp32") == 1.0
    assert yardstick.least_seconds(0, 67e12, "fp32") == 1.0
    assert yardstick.least_seconds(0, 989e12, "bf16") == 1.0
