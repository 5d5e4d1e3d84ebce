"""Roofline share (%) of K2, the correlation window
(liso_tpu_torch/kernels/corr_window_fwd.cu), in the streaming step's flow
stage: its kernels found by name among the device events launched under
the program's `stream.flow` span, one by one or by a CUDA graph's replay
(`kernel_names`), each launch's bytes and operations counted from the
cell's shapes by `yardstick.corr_window_cost`."""
import torch

from portbench import kernel_names, yardstick

KERNEL = "corr_window_fwd_kernel"


def f1cat_rows(h: int, w: int, levels: int):
    """(rows of f1cat, levels in it) for a coarse grid of h x w: the
    program's stack of 2x2-pooled levels, the pooling halting once a level
    drops below 4 px, each level's extents padded up to a multiple of 8 (at
    least 8) and the total to a multiple of 8."""
    pad = lambda x: max(-(-x // 8) * 8, 8)  # noqa: E731
    rows, n = 0, 0
    for _ in range(levels):
        rows += pad(h) * pad(w)
        n += 1
        if min(h, w) < 4:
            break
        h, w = h // 2, w // 2
    return -(-rows // 8) * 8, n


def lookup_cost(workload):
    """(bytes, operations) of one K2 launch of the cell's flow stage: f0
    [B, HW, C] and f1cat [B, M, C] in bf16, coords [B, 2, HW] in fp32 in;
    the taps [B, levels * (2r+2)^2, HW] in fp32 out."""
    c = workload.config
    s = c["slim"]
    b = int(workload.streams)
    h = w = -(-int(c["grid_size"]) // int(s["downsample"]))
    ch, r = int(s["corr_feature_dim"]), int(s["corr_radius"])
    rows, n_levels = f1cat_rows(h, w, int(s["corr_levels"]))

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    return yardstick.corr_window_cost(
        meta(b, h * w, ch), meta(b, rows, ch),
        meta(b, 2, h * w, dtype=torch.float32), None, r,
        meta(b, n_levels * (2 * r + 2) ** 2, h * w, dtype=torch.float32))()


def read(record):
    found = kernel_names.events(record, "stream.flow", (KERNEL,))
    if not found:
        return None
    device_s = sum(e.dur for e in found) * 1e-6
    least = len(found) * yardstick.least_seconds(
        *lookup_cost(record.workload), "bf16")
    return 100.0 * least / device_s
