"""The readings that a cell's limits are set from: for each seed, the
numbers that decide `correct` for the program (set-up, the steps that a
run's check samples, the check; no measured window) and, with
`--control`, for the control in the program's place. One process for all
seeds, so the set-up of the chip is paid once.

    python3 -m portbench.readings --workload <cell> --seeds 1 2 3 \
        [--control] [--program] [--fault <kind>]

Prints one JSON line per seed and side.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

import torch

from portbench import harness


def program_numbers(entry, config, traffic, seed, device, tmpdir) -> dict:
    w = entry.Workload(config, traffic, seed, device, tmpdir)
    w.setup()
    while not w.sampled_all():
        w.step()
    w.close_program()
    ok, checks = w.check()
    out = {"correct": ok, **{k: v["value"] for k, v in checks.items()}}
    if hasattr(w, "last_details"):
        out["details"] = w.last_details
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--kind", help="the control's precision (the entry's "
                   "default: the next lower one)")
    p.add_argument("--fault", choices=("stale_state", "half_batch", "altered"),
                   help="the program's readings with this fault planted")
    args = p.parse_args(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.find_cell(args.workload, bench)
    config = harness.load_json(harness.PB / "configs" / f"{cell['config']}.json")
    traffic = harness.load_json(harness.PB / "traffic" / f"{cell['traffic']}.json")
    import importlib

    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in args.seeds:
        for side in ("program", "control"):
            if not getattr(args, side):
                continue
            tmpdir = Path(tempfile.mkdtemp(prefix="portbench-"))
            try:
                if side == "program" and args.fault:
                    from portbench import faults

                    with faults.plant(traffic["entry"], args.fault):
                        nums = program_numbers(entry, config, traffic, seed,
                                               device, tmpdir)
                elif side == "program":
                    nums = program_numbers(entry, config, traffic, seed,
                                           device, tmpdir)
                else:
                    w = entry.Workload(config, traffic, seed, device, tmpdir)
                    w.make_inputs()
                    nums = w.control_numbers(*([args.kind] if args.kind else []))
            finally:
                shutil.rmtree(tmpdir, ignore_errors=True)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "fault": args.fault, **nums}),
                             flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
