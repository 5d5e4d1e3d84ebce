"""Time K1 (`grid_scatter_max_occ`), K4 (`grid_gather`) and K1-add
(`grid_reduce_add`) of several trees of the repository in turns, on one
card, in one call (GPU machine).

    git archive PARENT_COMMIT | tar -x -C .parent    # an ignored dir
    python3 liso_tpu_torch/kernels/time_against_parent.py .parent . . .parent

Each tree named runs in its own process, in the order given, and imports
its own `liso_tpu_torch` (its kernels build into its own `_build/`). At
each of `chip_smoke.py`'s shapes it reports the kernel alone (kernel_only_ms:
torch.profiler, mean of 20 launches), one wrapper call between two CUDA
events (ms: median of 20) and the wrapper's enqueue time (host_ms), with
`chip_smoke.py`'s own timers. The cells, as `prepare_pillar_inputs` sorts
them: the SLIM train step's frame 0 (the train benchmark's clouds, grid 920
over 120 m), the detector's background (uniform in +-45 m, z in [-1, 1.5],
grid 512 over 100 m) and the serving clouds (uniform in a 90 m cube, batch
8, grid 512 over 100 m).
A shape a tree's wrapper refuses is reported with its error. Prints one
JSON line per tree and writes them to chiprun_out/time_against_parent.json.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _cells(grid, range_m, half, n, b, z):
    """Sorted cell ids of b clouds of n points uniform in +-half m (z in
    `z` where given, else in +-half too) on a grid over range_m."""
    import numpy as np
    import torch

    from liso_tpu_torch.models.pillar_encoder import prepare_pillar_inputs
    from liso_tpu_torch.ops.bev import BevSetup

    rng = np.random.RandomState(0)
    pts = rng.uniform(-half, half, (b, n, 4)).astype(np.float32)
    if z is not None:
        pts[..., 2] = rng.uniform(*z, (b, n))
    bev = BevSetup((range_m, range_m), (grid, grid))
    pcl = torch.from_numpy(pts).cuda()
    valid = torch.ones(b, n, dtype=torch.bool, device="cuda")
    return prepare_pillar_inputs(pcl, valid, bev).cell, bev.num_cells


def time_tree(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    import liso_tpu_torch
    from liso_tpu_torch.ops import grid_scatter

    gen = torch.Generator(device="cuda").manual_seed(0)
    slim, slim_nc = _cells(920, 120.0, 58.0, 65536, 1, None)
    det, det_nc = _cells(512, 100.0, 45.0, 32768, 2, (-1.0, 1.5))
    serve, serve_nc = _cells(512, 100.0, 45.0, 32768, 8, None)
    cases = {
        "K1 serving [8, 32768, 128] bf16": ("max", serve, serve_nc, 128, torch.bfloat16),
        "K1 SLIM [1, 65536, 64] bf16": ("max", slim, slim_nc, 64, torch.bfloat16),
        "K1 detector [2, 32768, 64] fp32": ("max", det, det_nc, 64, torch.float32),
        "K4 SLIM [1, 846400, 64] bf16": ("gather", slim, slim_nc, 64, torch.bfloat16),
        "K4 detector [2, 262144, 64] fp32": ("gather", det, det_nc, 64, torch.float32),
        "K4 decoder [1, 846400, 2] fp32": ("gather", slim, slim_nc, 2, torch.float32),
        "K1-add (a) [1, 65536, 64] bf16": ("add", slim, slim_nc, 64, torch.bfloat16),
        "K1-add (b) [1, 65536, 2] fp32": ("add", slim, slim_nc, 2, torch.float32),
    }
    out = {"tree": tree, "package": liso_tpu_torch.__file__}
    for name, (op, cells, nc, c, dt) in cases.items():
        b, n = cells.shape
        if op == "gather":
            x = torch.randn(b, nc, c, generator=gen, device="cuda").to(dt)
            fn, kernel = (lambda: grid_scatter.grid_gather(x, cells)), "grid_gather_kernel"
        elif op == "add":
            x = torch.randn(b, n, c, generator=gen, device="cuda").to(dt)
            fn = lambda: grid_scatter.grid_reduce_add(x, cells, nc)  # noqa: E731
            kernel = "grid_reduce_add_kernel"
        else:
            x = torch.randn(b, n, c, generator=gen, device="cuda").to(dt)
            fn = lambda: grid_scatter.grid_scatter_max_occ(x, cells, nc)  # noqa: E731
            kernel = "grid_scatter_max_occ_kernel"
        try:
            fn()
        except ValueError as e:  # a wrapper that refuses the shape
            out[name] = {"refused": str(e)}
            continue
        out[name] = {"kernel_only_ms": cs.kernel_only_ms(fn, kernel),
                     "ms": cs.cuda_ms(fn), "host_ms": cs.host_ms(fn)}
    return out


def main(trees) -> int:
    rows = []
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--one", tree],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "time_against_parent.json").write_text(
        json.dumps({"nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip(), "runs": rows}, indent=1))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(time_tree(sys.argv[2])))
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
