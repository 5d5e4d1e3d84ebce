"""The per-layer metrics that read the program's own spans and counters
(`portbench/program_spans.py`): a traced run of each cell at a small size on
the CPU reports them, and on the card the streaming step's four spans cover
every device operation that the step launches."""
import math
import tempfile
from pathlib import Path

import pytest
import torch

from portbench import trace
from portbench.tests.small import BENCH, run_small, small_cell

NEW = {
    "stream_b8": ("encode_ms.stream", "flow_ms.stream", "detect_ms.stream",
                  "flow_host_ms.stream"),
    "round_step_b2": ("loss_host_ms.det", "backward_host_ms.det",
                      "optimizer_host_ms.det", "loader_empty.det"),
}
STREAM_SPANS = ("stream.pillars", "stream.encode", "stream.flow",
                "stream.detect")


@pytest.mark.parametrize("name", sorted(NEW))
def test_traced_small_run_reports_the_program_spans(name, tmp_path,
                                                    no_tensorboard):
    r = run_small(name, trace=True, tmp=tmp_path)
    assert r["correct"], r["checks"]
    for metric in NEW[name]:
        assert metric in r["metrics"], (metric, sorted(r["metrics"]))
        assert math.isfinite(r["metrics"][metric]["value"])
    listed = {m["name"] for m in BENCH["per_layer"]
              if name in m.get("workloads", ())}
    assert set(NEW[name]) <= listed


@pytest.mark.cuda
def test_stream_spans_cover_the_step_on_the_card(cuda_device):
    """The device ms launched under the four `stream.*` spans add up to the
    device ms launched under the benchmark's `pb.stream_step`, within 3%."""
    import importlib

    cell, config, traffic = small_cell("stream_b8")
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    tmp = Path(tempfile.mkdtemp())
    w = entry.Workload(config, traffic, 2**31 + 7, cuda_device, tmp)
    w.setup()
    tv = trace.profile_steps(w.step, 5, tmp)
    torch.cuda.synchronize()
    step = tv.device_s(lambda stack: "pb.stream_step" in stack)
    spans = sum(tv.device_s(lambda stack, s=s: s in stack)
                for s in STREAM_SPANS)
    assert step > 0
    assert abs(spans - step) <= 0.03 * step, (spans, step)
