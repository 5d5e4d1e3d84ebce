"""The yardstick: the chip's peaks, the operations a model's step needs,
and the bytes and operations of each hand-written kernel's op, counted
from shapes. Later changes to the program do not move it.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity): 989
TFLOP/s bf16, 67 TFLOP/s fp32 outside the tensor cores,
3.35 TB/s of HBM. They assume the card's full 700 W; a run reports the
card's power limit beside its shares.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
from torch import nn

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def least_seconds(nbytes: float, nops: float, precision: str) -> float:
    """The least time the chip could take: bytes over the memory rate or
    operations over the precision's peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, nops / PEAK_FLOPS[precision])


def conv_flops(module: nn.Module, inp: torch.Tensor,
               out: torch.Tensor) -> float:
    """Multiply-adds x 2 of one call of a convolution or linear layer."""
    if isinstance(module, nn.ConvTranspose2d):
        # every input pixel meets the whole kernel
        kh, kw = module.kernel_size
        per_in = module.out_channels // module.groups * kh * kw
        return 2.0 * inp.numel() * per_in
    if isinstance(module, nn.Conv2d):
        kh, kw = module.kernel_size
        per_out = module.in_channels // module.groups * kh * kw
        return 2.0 * out.numel() * per_out
    if isinstance(module, nn.Linear):
        return 2.0 * out.numel() * module.in_features
    return 0.0


@contextmanager
def count_flops(model: nn.Module):
    """Within the block, every convolution and linear call of `model` adds
    its operations to the yielded dict's "flops" (run the model on the
    meta device: shapes only, nothing is computed)."""
    total = {"flops": 0.0}

    def hook(m, args, out):
        total["flops"] += conv_flops(m, args[0], out)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    try:
        yield total
    finally:
        for h in handles:
            h.remove()


def corr_lookup_flops(batch: int, hw: int, channels: int, levels: int,
                      radius: int) -> float:
    """One correlation lookup of RAFT: every pixel takes the (2r+2)^2 raw
    taps that a bilinear (2r+1)^2 window needs, on every level, each a
    dot product of `channels`."""
    return 2.0 * batch * hw * levels * (2 * radius + 2) ** 2 * channels


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


# --- the hand-written kernels' ops: (bytes, operations) from their own
# inputs and outputs, each byte read or written once, and where the work
# depends on the data, what these inputs need. Each returns a function
# that counts, so a traced window keeps only small tensors (the cell ids)
# and counts after it has closed, with no synchronise inside it.
def _cells_counts(cells, num_cells: int):
    """(points inside the grid, distinct occupied (sample, cell) pairs) of
    cell-sorted ids, ids >= num_cells dropped."""
    inside = cells < num_cells
    new = torch.ones_like(inside)
    new[..., 1:] = cells[..., 1:] != cells[..., :-1]
    return int(inside.sum()), int((new & inside).sum())


def scatter_max_cost(feats, cells, num_cells, out):
    """K1: the cell ids and the rows of the points inside the grid in; the
    whole grid [B, NC, C] and occ [B, NC, 1] out (every cell is written);
    one compare per feature read."""
    grid, occ = out
    c, es = feats.shape[-1], feats.element_size()
    fixed = nbytes(cells, grid, occ)

    def count():
        n_in, _ = _cells_counts(cells, num_cells)
        return fixed + n_in * c * es, float(n_in * c)
    return count


def scatter_max_vjp_cost(feats, cells, grid, g_grid, out):
    """The fused scatter-max VJP: the cell ids, the rows of the points
    inside the grid, and the grid's and the cotangent's rows at the
    occupied cells in; every row of dfeats out; a compare and a select per
    feature read."""
    c, es = feats.shape[-1], feats.element_size()
    num_cells = grid.shape[1]
    fixed = nbytes(cells, out)

    def count():
        n_in, n_occ = _cells_counts(cells, num_cells)
        return fixed + (n_in + 2 * n_occ) * c * es, 2.0 * n_in * c
    return count


def corr_window_cost(f0, f1cat, coords_t, levels, radius, out):
    """K2: f0 [B, HW, C], f1cat [B, M, C] and coords [B, 2, HW] in, the raw
    taps [B, L * (2r+2)^2, HW] out; a dot product of C per tap."""
    b, hw, c = f0.shape
    taps = out.shape[1]
    total = nbytes(f0, f1cat, coords_t, out), 2.0 * b * hw * c * taps
    return lambda: total


def precision_of(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "fp32"
