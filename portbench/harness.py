"""One run of one cell: set-up, the measured window, the traced
sub-window, the correctness check, and the result line.

The cell is found by name in `BENCHMARK.json`; its configuration in
`portbench/configs/<config>.json`, its traffic mix in
`portbench/traffic/<traffic>.json`, whose `entry` names the module of
`portbench/entries/` that drives the program, and each per-layer metric's
reader in `portbench/metrics/<metric>.py`. Nothing here names a cell.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PB = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "liso_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, bench: dict) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") that `cell`
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole (`liso_tpu_torch` is not `liso_tpu`)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_reader(metric: str):
    path = PB / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_info() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return {"nvidia_smi": out[0] if out else "not read"}
    except (OSError, subprocess.SubprocessError):
        return {"nvidia_smi": "not read"}


class RunRecord:
    """What the per-layer readers read: the window's steps and stage
    times (host clock), the device-only traced pass (`device`: busy_s,
    window_s, device_ops), the traced sub-window with host operators
    (`trace`), the kernels' op costs counted in it (`op_costs`: label ->
    [bytes, operations, precision]), and the workload's own constants
    (`flops_per_step`, `precision`)."""

    def __init__(self, workload):
        self.workload = workload
        self.step_s = []
        self.items = 0
        self.window_s = 0.0
        self.stages = {}
        self.trace = None
        self.device = None
        self.op_costs = {}

    def stage_ms_per_step(self, stage: str):
        """Host ms per window step in one of the benchmark's stages (its
        own span around the call into that layer); None without it."""
        if stage not in self.stages or not self.step_s:
            return None
        return self.stages[stage] / len(self.step_s) * 1e3


def run_window(workload, seconds: float, record: RunRecord) -> None:
    """Steps until `seconds` have passed; each step ends with its results
    on the host, so the next starts after it (a closed loop)."""
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        items, stages = workload.step()
        t1 = time.perf_counter()
        record.step_s.append(t1 - t0)
        record.items += items
        for k, v in stages.items():
            record.stages[k] = record.stages.get(k, 0.0) + v
        if t1 - t_start >= seconds:
            break
    record.window_s = time.perf_counter() - t_start


def p95(values) -> float:
    """The 95th percentile (inclusive quantiles; a lone value is its own)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def main(args, t_process_start: float) -> int:
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(args.workload, bench)
    config = load_json(PB / "configs" / f"{cell['config']}.json")
    traffic = load_json(PB / "traffic" / f"{cell['traffic']}.json")
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    tmpdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        result = run_cell(bench, cell, config, traffic, args.seed,
                          float(args.seconds), bool(args.trace), device,
                          tmpdir, t_process_start)
    finally:
        import shutil

        shutil.rmtree(tmpdir, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 4
    result["card"] = card_info()
    checks = result.pop("checks")
    result["checks"] = checks  # the compared numbers come last
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def run_cell(bench, cell, config, traffic, seed: int, seconds: float,
             trace_on: bool, device, tmpdir, t_start: float) -> dict:
    """One run of `cell` on `device`; returns the result line's object
    (without the card's name), `checks` holding each compared number
    with its limit."""
    import torch

    cuda = device.type == "cuda"
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    t_setup = time.perf_counter()
    workload = entry.Workload(config, traffic, seed, device, tmpdir)
    workload.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"set-up: {t_setup - t_start:.2f} s to the cell's start (interpreter, "
          f"imports, CUDA), {setup_s - (t_setup - t_start):.2f} s the cell's "
          f"{getattr(workload, 'phases', {})}", file=sys.stderr)

    record = RunRecord(workload)
    run_window(workload, seconds, record)
    if trace_on:
        from portbench import trace

        if cuda:
            record.device = trace.device_pass(workload.step,
                                              workload.trace_steps, tmpdir)
        with workload.instrumented(record):
            record.trace = trace.profile_steps(
                workload.step, workload.trace_steps, tmpdir)
        if not cuda:
            record.device = {"busy_s": record.trace.busy_s(),
                             "window_s": record.trace.window_s,
                             "device_ops": record.trace.top_ops()}
    n = len(record.step_s)
    print(f"window: {n} steps in {record.window_s:.3f} s; host ms a step by "
          f"stage: {({k: round(v / n * 1e3, 3) for k, v in record.stages.items()})}",
          file=sys.stderr)
    memory_peak = 0
    if cuda:
        torch.cuda.synchronize()
        memory_peak = int(torch.cuda.max_memory_allocated(device))
    workload.close_program()
    correct, checks = workload.check()

    e2e = {"setup_s": setup_s}
    e2e.update(workload.end_to_end(record))
    metrics = {}
    if not trace_on:
        for m in cell_metrics(bench, cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell["name"], "per_layer"):
            value = load_reader(m["name"])(record)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": int(cell["chips"]),
        "memory_peak_bytes": memory_peak,
    }
    result = {"correct": bool(correct), "attempted": len(record.step_s),
              "failed": 0, "metrics": metrics, "device": dev}
    if trace_on:
        dev["busy_s"] = record.device["busy_s"]
        dev["window_s"] = record.device["window_s"]
        result["breakdown"] = {"device_ops": record.device["device_ops"],
                               "idle_gaps": record.trace.top_gaps()}
    result["checks"] = checks
    return result
