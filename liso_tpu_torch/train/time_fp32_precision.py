"""Time what `DetectorTrainer`'s fp32 pin costs the detector train step.

    python3 -m liso_tpu_torch.train.time_fp32_precision

`train_step` runs inside `detector_train.fp32_precision()`, which turns
TF32 off for cuDNN and cuBLAS and puts the caller's settings back. This
script times, in one process on the card, (a) one enter and exit of that
context (mean of 10000), and (b) the full-width detector train step of
`chip_smoke.py`'s `detect_train` phase (grid 512 over 100 m, batch 2, 32768
points, the synthetic drive) in turns with and without the pin, TF32 off
globally for the unpinned step, 12 steps each after 3 warm-up pairs, the
order swapped every pair. Host clock, each step awaited. It prints one JSON
line and writes it to `chiprun_out/fp32_precision.json`.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import torch

from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.train import detector_train

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # the detect_train phase's scene and sizes

    if not torch.cuda.is_available():
        print("time_fp32_precision: needs a GPU", file=sys.stderr)
        return 2
    n = 10000
    t0 = time.perf_counter()
    for _ in range(n):
        with detector_train.fp32_precision():
            pass
    toggle_us = (time.perf_counter() - t0) / n * 1e6

    bev = BevSetup((cs.D_RANGE, cs.D_RANGE), (cs.D_GRID, cs.D_GRID))
    trainer = detector_train.DetectorTrainer(
        bev, max_lr=cs.D_MAX_LR, total_steps=cs.D_TOTAL_STEPS, seed=0,
        device="cuda")
    pts, valid, target = cs.drive_scene()
    unpinned = detector_train.DetectorTrainer.train_step.__wrapped__
    steps = {
        "pinned": lambda: trainer.train_step(pts, valid, target),
        "unpinned": lambda: unpinned(trainer, pts, valid, target),
    }
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for _ in range(3):
        for fn in steps.values():
            fn()
    ms = {k: [] for k in steps}
    order = list(steps)
    for i in range(12):
        for name in order if i % 2 else order[::-1]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            steps[name]()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t) * 1e3)
    out = {
        "nvidia_smi": cs.nvidia_smi(),
        "torch": torch.__version__,
        "toggle_us": toggle_us,
        **{f"{k}_step_ms_median": statistics.median(v) for k, v in ms.items()},
        **{f"{k}_step_ms_min": min(v) for k, v in ms.items()},
        "step_ms": ms,
    }
    print(json.dumps(out), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "fp32_precision.json").write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
