"""Time TransFusion's `reduce` convolution (3x3, 256 -> 128 channels over
the 128^2 cells of the /4 grid at grid 512, fp32, TF32 off) through cuDNN
and through PyTorch's own CUDA convolution (im2col and a cuBLAS GEMM), at
the batches the port runs it: 1 (validation), 2 (a train step), 8 (a
mining chunk). GPU only:

    python3 -m liso_tpu_torch.models.time_reduce_conv

Prints one JSON line per batch: forward ms and forward + backward ms of
each route (CUDA events, median of 10 calls after 2), and the largest
difference of the two forwards."""
from __future__ import annotations

import json
import statistics
import subprocess

import torch

from liso_tpu_torch.models.layers import Conv
from liso_tpu_torch.train.slim_train import fp32_precision


def _ms(fn, reps=10):
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("time_reduce_conv: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with fp32_precision():
        for n in (1, 2, 8):
            x = torch.randn(n, 256, 128, 128, generator=gen, device="cuda")
            w = 0.02 * torch.randn(128, 256, 3, 3, generator=gen, device="cuda")
            out = {"card": smi, "batch": n}
            ys = {}
            for route, cudnn in (("cudnn", True), ("pytorch", False)):
                conv = Conv(256, 128, 3, bias=False, cudnn=cudnn, device="cuda")
                with torch.no_grad():
                    conv.weight.copy_(w)
                    ys[route] = conv(x)
                xg = x.clone().requires_grad_(True)
                out[f"{route}_fwd_ms"] = _ms(lambda: conv(x))
                out[f"{route}_fwd_bwd_ms"] = _ms(
                    lambda: conv(xg).square().sum().backward())
            out["max_abs_diff"] = float((ys["cudnn"] - ys["pytorch"]).abs().max())
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
