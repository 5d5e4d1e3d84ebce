"""Cells cut to a size a CPU test run holds: the real configuration and
traffic files with their sizes shrunk, so the same code runs."""
import tempfile
import time
from pathlib import Path

import torch

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def small_cell(name: str):
    cell = harness.find_cell(name, BENCH)
    config = harness.load_json(harness.PB / "configs" / f"{cell['config']}.json")
    traffic = harness.load_json(harness.PB / "traffic" / f"{cell['traffic']}.json")
    config.update(grid_size=64, bev_range_m=40.0, n_max=4096)
    config["slim"]["num_iters"] = 2
    if traffic["entry"] == "stream":
        traffic.update(streams=2, frames=6, points=[2000, 3000], check_from=2,
                       check_steps=2, warmup_steps=1, trace_steps=2)
    else:
        traffic.update(frames=8, points=[2000, 3000], ground_points=500,
                       warmup_steps=1, objects=6, trace_steps=2)
    return cell, config, traffic


def run_small(name: str, seed: int = 2**31 + 5, seconds: float = 3.0,
              trace: bool = False, tmp=None) -> dict:
    cell, config, traffic = small_cell(name)
    tmpdir = Path(tmp or tempfile.mkdtemp())
    return harness.run_cell(BENCH, cell, config, traffic, seed, seconds,
                            trace, torch.device("cpu"), tmpdir,
                            time.perf_counter())
