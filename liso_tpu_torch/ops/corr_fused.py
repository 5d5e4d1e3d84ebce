"""RAFT correlation window lookup on a never-materialised volume (port of
liso_tpu/ops/corr_fused_pallas.py).

corr[p, m] = <f0[p], f1cat[m]> / sqrt(C), rounded to bf16, where f1cat
stacks the 2x2-avg-pooled levels of fmap1 (`pool_f1_levels`).
`fused_corr_window` returns the raw (2r+2)^2 integer taps per level around
floor(coords / 2^l); `corr_window_features` blends them bilinearly in the
reference's tap order. `fused_corr_window` is differentiable in f0 and
f1cat with the TPU VJP (`corr_fused_pallas.py:329-377`): the taps'
cotangent is scaled and rounded to bf16 per element, then df0 and df1 are
formed from the windowed entries (`corr_window_bwd`). The forward launches
the CUDA kernel `kernels/corr_window_fwd.cu` (K2) and the backward
`kernels/corr_window_bwd.cu` (K5) for CUDA tensors; both run their plain
PyTorch versions (`*_plain`) where `kernels.use_plain` says: for CPU
tensors, inside `kernels.plain_versions()`, or when the caller passes
`plain=True`. The backward runs plain where its forward did, or inside a
scope (`kernels.plain_versions`).
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from liso_tpu_torch import kernels


class CorrLevels(NamedTuple):
    """Static geometry of the pooled-f1 level stack: per level PADDED
    (hk, wk) layouts (each dim a multiple of 8, pad rows zero), their row
    offsets in f1cat, the padded total row count, and the true pooled
    extents."""

    shapes: Tuple[Tuple[int, int], ...]
    offsets: Tuple[int, ...]
    total: int
    logical: Tuple[Tuple[int, int], ...] = ()


_ROW_PAD = 8
_LVL_PAD = 8


def _pad_dim(x: int) -> int:
    return max(-(-x // _LVL_PAD) * _LVL_PAD, _LVL_PAD)


def level_geometry(h: int, w: int, num_levels: int) -> CorrLevels:
    """Level-stack geometry for a coarse fmap of (h, w): pooling halts once
    a level would drop below 4 px (as the reference pyramid does)."""
    logical: List[Tuple[int, int]] = []
    hk, wk = h, w
    for _ in range(num_levels):
        logical.append((hk, wk))
        if min(hk, wk) < 4:
            break
        hk, wk = hk // 2, wk // 2
    shapes = [(_pad_dim(a), _pad_dim(b)) for a, b in logical]
    offsets = []
    off = 0
    for sh, sw in shapes:
        offsets.append(off)
        off += sh * sw
    total = -(-off // _ROW_PAD) * _ROW_PAD
    return CorrLevels(tuple(shapes), tuple(offsets), total, tuple(logical))


class _RoundToBf16(torch.autograd.Function):
    """x -> bf16(x), held in x's fp32; the cotangent passes through in fp32.
    jax's astype VJP converts the cotangent back, and under jit XLA keeps a
    sum of bf16 cotangents in fp32: the cotangents of the several lookups
    that share one f1cat add up in fp32, not rounded to bf16 after each."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def pool_f1_levels(fmap1: torch.Tensor, num_levels: int):
    """fmap1 [B, H, W, C] -> (f1cat [B, M, C], CorrLevels): the 2x2
    average-pooling chain of fmap1, each level zero-padded to its layout
    (a tap in the pad reads 0, the reference's grid_sample zeros), rounded
    to bf16. f1cat is bf16, or, when fmap1 requires grad, fp32 holding the
    bf16 values (`_RoundToBf16`)."""
    b, h, w, c = fmap1.shape
    levels = level_geometry(h, w, num_levels)
    flats = []
    f1l = fmap1.float().permute(0, 3, 1, 2)  # NCHW for avg_pool2d
    for i, ((hk, wk), (hp, wp)) in enumerate(zip(levels.logical, levels.shapes)):
        lv = F.pad(f1l, (0, wp - wk, 0, hp - hk))
        flats.append(lv.permute(0, 2, 3, 1).reshape(b, hp * wp, c))
        if i + 1 < len(levels.shapes):
            f1l = F.avg_pool2d(f1l, 2, 2)
    f1cat = torch.cat(flats, dim=1)
    f1cat = F.pad(f1cat, (0, 0, 0, levels.total - f1cat.shape[1]))
    if torch.is_grad_enabled() and f1cat.requires_grad:
        return _RoundToBf16.apply(f1cat).contiguous(), levels
    return f1cat.to(torch.bfloat16).contiguous(), levels


def _scale(c: int) -> float:
    return 1.0 / float(c) ** 0.5


def _window_cells(coords_t, levels: CorrLevels, radius: int, lvl: int):
    """Cell of every tap of level `lvl` in f1cat: (flat [B, HW, w1*w1]
    int64, ok [B, HW, w1*w1] bool, False where the tap lies outside the
    level's padded extent)."""
    b, _, hw = coords_t.shape
    w1 = 2 * radius + 2
    hk, wk = levels.shapes[lvl]
    d = torch.arange(-radius, radius + 2, device=coords_t.device)
    r0 = torch.floor(coords_t[:, 0] / (2.0**lvl)).clamp(-1e6, 1e6).long()
    c0 = torch.floor(coords_t[:, 1] / (2.0**lvl)).clamp(-1e6, 1e6).long()
    rows = r0[..., None] + d
    cols = c0[..., None] + d
    ok = ((rows >= 0) & (rows < hk))[..., :, None] & (
        (cols >= 0) & (cols < wk)
    )[..., None, :]
    flat = (
        levels.offsets[lvl]
        + rows.clamp(0, hk - 1)[..., :, None] * wk
        + cols.clamp(0, wk - 1)[..., None, :]
    )
    return flat.reshape(b, hw, w1 * w1), ok.reshape(b, hw, w1 * w1)


def fused_corr_window_plain(
    f0: torch.Tensor, f1cat: torch.Tensor, coords_t: torch.Tensor,
    levels: CorrLevels, radius: int,
):
    """f0 [B, HW, C], f1cat [B, M, C] bf16 values (`pool_f1_levels`),
    coords_t [B, 2, HW] fp32 (row,
    col at level 0) -> taps [B, L*(2r+2)^2, HW] fp32. The whole corr block
    is one fp32 matmul of the bf16 operands (products exact), scaled and
    rounded to bf16; taps outside a level's padded extent are 0."""
    c = f0.shape[-1]
    corr = torch.matmul(
        f0.to(torch.bfloat16).float(), f1cat.float().transpose(1, 2)
    )
    corr = (corr * _scale(c)).to(torch.bfloat16).float()  # [B, HW, M]
    taps = []
    for lvl in range(len(levels.shapes)):
        flat, ok = _window_cells(coords_t, levels, radius, lvl)
        taps.append(torch.where(ok, torch.gather(corr, 2, flat), 0.0))
    return torch.cat(taps, dim=-1).transpose(1, 2).contiguous()


def sum_order_slack(
    f0: torch.Tensor, f1cat: torch.Tensor, coords_t: torch.Tensor,
    levels: CorrLevels, radius: int,
):
    """Per tap [B, L*(2r+2)^2, HW]: how far two fp32 sums of the same C
    products, taken in different orders, can lie apart after the scaling:
    2 * C * 2^-24 * scale * sum_c |f0_c * f1_c| (the recursive-sum bound,
    twice). Where a dot cancels to near 0 this exceeds one bf16 ulp of the
    result, so two implementations that sum in different orders agree to
    one bf16 ulp of the value plus this slack."""
    c = f0.shape[-1]
    abs_taps = fused_corr_window_plain(
        f0.to(torch.bfloat16).abs(), f1cat.abs(), coords_t, levels, radius
    )  # scale * sum |products|, rounded to bf16: at most 2^-8 low
    return abs_taps * (2 * c * 2.0**-24 * (1 + 2.0**-7))


def _level_meta(levels: CorrLevels, *extra: int):
    """Host array of (h, w, offset) per level, as the kernels take it, then
    `extra`."""
    meta = [v for (hk, wk), off in zip(levels.shapes, levels.offsets)
            for v in (hk, wk, off)] + list(extra)
    return (ctypes.c_int * len(meta))(*meta)


def _fused_corr_window_fwd(f0, f1cat, coords_t, levels, radius, plain):
    if kernels.use_plain(f0, plain):
        return fused_corr_window_plain(f0, f1cat, coords_t, levels, radius)
    dev = f0.device
    if dev.type != "cuda" or f1cat.device != dev or coords_t.device != dev:
        raise ValueError("f0, f1cat and coords_t must lie on one CUDA device")
    if radius != 3:
        raise ValueError(f"the CUDA kernel takes radius 3, got {radius}")
    b, hw, c = f0.shape
    if (
        f1cat.shape != (b, levels.total, c)
        or coords_t.shape != (b, 2, hw)
        or c not in (16, 32, 64, 128, 256)
        or hw != levels.logical[0][0] * levels.logical[0][1]
    ):
        raise ValueError(
            f"f0 {tuple(f0.shape)}, f1cat {tuple(f1cat.shape)} "
            f"{f1cat.dtype}, coords_t {tuple(coords_t.shape)}, "
            f"levels.total {levels.total}"
        )
    f0 = f0.to(torch.bfloat16).contiguous()
    f1cat = f1cat.to(torch.bfloat16).contiguous()
    coords_t = coords_t.to(torch.float32).contiguous()
    if f0.data_ptr() % 16 or f1cat.data_ptr() % 16:
        raise ValueError("f0 and f1cat must be 16-byte aligned")
    nl = len(levels.shapes)
    meta = _level_meta(levels, levels.logical[0][1])
    out = torch.empty(b, nl * 64, hw, dtype=torch.float32, device=dev)
    fn = kernels.function("corr_window_fwd")
    kernels.check(
        fn(
            f0.data_ptr(), f1cat.data_ptr(), coords_t.data_ptr(),
            out.data_ptr(), b, hw, c, levels.total, nl, meta, _scale(c),
            kernels.stream(dev),
        ),
        "corr_window_fwd",
    )
    kernels.launches["corr_window_fwd"] += 1
    return out


def _dense_corr_cotangent(g, coords_t, levels: CorrLevels, radius: int,
                          scale: float):
    """The TPU kernel's [B, HW, M] corr cotangent: each in-range tap's
    bf16(g * scale) at its cell, 0 elsewhere (taps of one pixel and level
    hit distinct cells, so the placement is exact)."""
    b, _, hw = coords_t.shape
    m = levels.total
    w1 = 2 * radius + 2
    d = (g * scale).to(torch.bfloat16).float()
    dcorr = torch.zeros(b, hw, m + 1, dtype=torch.float32, device=g.device)
    for lvl in range(len(levels.shapes)):
        flat, ok = _window_cells(coords_t, levels, radius, lvl)
        flat = torch.where(ok, flat, m)  # out of range: the sink column
        dl = d[:, lvl * w1 * w1 : (lvl + 1) * w1 * w1].transpose(1, 2)
        dcorr.scatter_(2, flat, torch.where(ok, dl, 0.0))
    return dcorr[..., :m]


def corr_window_bwd_plain(f0, f1cat, coords_t, g, levels: CorrLevels,
                          radius: int):
    """g [B, L*(2r+2)^2, HW] fp32, the taps' cotangent -> (df0 [B, HW, C],
    df1 [B, M, C]), both fp32: the corr cotangent of
    `_dense_corr_cotangent`, then df0 = dcorr f1cat and df1 = dcorr^T
    bf16(f0) as two fp32 matmuls (bf16 x bf16 products are exact)."""
    dcorr = _dense_corr_cotangent(
        g.float(), coords_t, levels, radius, _scale(f0.shape[-1])
    )
    df0 = torch.matmul(dcorr, f1cat.float())
    df1 = torch.matmul(dcorr.transpose(1, 2), f0.to(torch.bfloat16).float())
    return df0, df1


def bwd_sum_order_slack(f0, f1cat, coords_t, g, levels: CorrLevels,
                        radius: int):
    """Per output of `corr_window_bwd` (slack_df0 [B, HW, C], slack_df1
    [B, M, C]): how far two fp32 sums of the same n products, taken in
    different orders, can lie apart: 2 * n * 2^-24 * sum |product|, with n
    the count of non-zero cotangent entries that feed the output (the
    recursive-sum bound, twice). The kernel sums both with tensor-core
    products over a region of cells and df1 across blocks by atomics in no
    fixed order; the plain version sums by matmul."""
    dcorr = _dense_corr_cotangent(
        g.float(), coords_t, levels, radius, _scale(f0.shape[-1])
    )
    nz = (dcorr != 0).float()
    a = dcorr.abs()
    s0 = torch.matmul(a, f1cat.float().abs())
    s1 = torch.matmul(a.transpose(1, 2), f0.to(torch.bfloat16).float().abs())
    n0 = nz.sum(-1, keepdim=True)
    n1 = nz.sum(1).unsqueeze(-1)
    return 2 * n0 * 2.0**-24 * s0, 2 * n1 * 2.0**-24 * s1


def corr_window_bwd(f0, f1cat, coords_t, g, levels: CorrLevels, radius: int,
                    plain: bool = False):
    """The taps' cotangent -> (df0, df1) in fp32; same contract as
    `corr_window_bwd_plain`. The HW pixels form the grid of f1cat's first
    level (`levels.logical[0]`), row-major: the kernel takes 2-D tiles of
    them."""
    if kernels.use_plain(f0, plain):
        return corr_window_bwd_plain(f0, f1cat, coords_t, g, levels, radius)
    dev = f0.device
    if any(t.device != dev for t in (f1cat, coords_t, g)) or dev.type != "cuda":
        raise ValueError("f0, f1cat, coords_t and g must lie on one CUDA device")
    if radius != 3:
        raise ValueError(f"the CUDA kernel takes radius 3, got {radius}")
    b, hw, c = f0.shape
    nl = len(levels.shapes)
    if (
        f1cat.shape != (b, levels.total, c)
        or coords_t.shape != (b, 2, hw)
        or g.shape != (b, nl * 64, hw)
        or c % 32 != 0
        or hw != levels.logical[0][0] * levels.logical[0][1]
    ):
        raise ValueError(
            f"f0 {tuple(f0.shape)}, f1cat {tuple(f1cat.shape)} "
            f"{f1cat.dtype}, coords_t {tuple(coords_t.shape)}, g "
            f"{tuple(g.shape)}, levels.total {levels.total}"
        )
    f0 = f0.to(torch.bfloat16).contiguous()
    f1cat = f1cat.to(torch.bfloat16).contiguous()
    coords_t = coords_t.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    if f0.data_ptr() % 16 or f1cat.data_ptr() % 16:
        raise ValueError("f0 and f1cat must be 16-byte aligned")
    df0 = torch.zeros(b, hw, c, dtype=torch.float32, device=dev)
    df1 = torch.zeros(b, levels.total, c, dtype=torch.float32, device=dev)
    fn = kernels.function("corr_window_bwd")
    kernels.check(
        fn(
            f0.data_ptr(), f1cat.data_ptr(), coords_t.data_ptr(),
            g.data_ptr(), df0.data_ptr(), df1.data_ptr(), b, hw, c,
            levels.total, nl, _level_meta(levels, levels.logical[0][1]),
            _scale(c), kernels.stream(dev),
        ),
        "corr_window_bwd",
    )
    kernels.launches["corr_window_bwd"] += 1
    return df0, df1


class _FusedCorrWindow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f0, f1cat, coords_t, levels, radius, plain):
        plain = kernels.use_plain(f0, plain)
        out = _fused_corr_window_fwd(f0, f1cat, coords_t, levels, radius, plain)
        ctx.save_for_backward(f0, f1cat, coords_t)
        ctx.levels, ctx.radius, ctx.plain = levels, radius, plain
        return out

    @staticmethod
    def backward(ctx, g):
        f0, f1cat, coords_t = ctx.saved_tensors
        df0, df1 = corr_window_bwd(
            f0, f1cat, coords_t, g, ctx.levels, ctx.radius, ctx.plain
        )
        # the TPU VJP's casts (corr_fused_pallas.py:_fused_bwd): df1 to
        # bf16, held in f1cat's dtype; coords get none: the raw taps are
        # piecewise constant in them
        df1 = df1.to(torch.bfloat16).to(f1cat.dtype)
        return df0.to(f0.dtype), df1, None, None, None, None


def fused_corr_window(
    f0: torch.Tensor, f1cat: torch.Tensor, coords_t: torch.Tensor,
    levels: CorrLevels, radius: int, plain: bool = False,
):
    """Raw window taps; same contract as `fused_corr_window_plain`. f0 is
    rounded to bf16 first, as the TPU kernel does. Differentiable in f0
    and f1cat (see the module docstring). The HW pixels form the grid of
    f1cat's first level (`levels.logical[0]`), row-major: the kernels take
    2-D tiles of them."""
    return _FusedCorrWindow.apply(f0, f1cat, coords_t, levels, radius, plain)


def corr_window_features(
    f0_flat: torch.Tensor,  # [B, HW, C]
    f1cat: torch.Tensor,  # [B, M, C] bf16 values (pool_f1_levels)
    coords: torch.Tensor,  # [B, 2, H, W] (row, col), level-0 resolution
    levels: CorrLevels,
    radius: int = 3,
) -> torch.Tensor:
    """Bilinear window features [B, L*(2r+1)^2, H, W] fp32 in the
    reference's tap order (column offset on the first window axis). The
    channel order equals liso_tpu's [B, H, W, L*(2r+1)^2] output."""
    b, _, h, w = coords.shape
    hw = h * w
    win = 2 * radius + 1
    w1 = win + 1
    coords_t = coords.reshape(b, 2, hw)
    taps = fused_corr_window(f0_flat, f1cat, coords_t, levels, radius)
    outs = []
    for lvl in range(len(levels.shapes)):
        centers = coords_t / (2.0**lvl)
        frac = centers - torch.floor(centers)
        fr = frac[:, 0].reshape(b, 1, 1, hw)
        fc = frac[:, 1].reshape(b, 1, 1, hw)
        wnd = taps[:, lvl * w1 * w1 : (lvl + 1) * w1 * w1].reshape(b, w1, w1, hw)
        s = (
            wnd[:, :win, :win] * (1 - fr) * (1 - fc)
            + wnd[:, :win, 1:] * (1 - fr) * fc
            + wnd[:, 1:, :win] * fr * (1 - fc)
            + wnd[:, 1:, 1:] * fr * fc
        )
        outs.append(s.transpose(1, 2).reshape(b, win * win, hw))
    return torch.cat(outs, dim=1).reshape(b, -1, h, w)
