"""A run's result has the contract's keys, with the compared numbers last,
and a run of each cell at a small size on the CPU comes out correct."""
import pytest

from portbench.tests.small import BENCH, run_small

REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["workloads"]])
def test_small_run_is_correct(name, tmp_path, no_tensorboard):
    r = run_small(name, tmp=tmp_path)
    assert REQUIRED <= set(r)
    assert list(r)[-1] == "checks"
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    wanted = {m["name"] for m in BENCH["end_to_end"]
              if "workloads" not in m or name in m["workloads"]}
    assert set(r["metrics"]) == wanted
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}


def test_traced_run_reports_breakdown(tmp_path):
    r = run_small("stream_b8", trace=True, tmp=tmp_path)
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert list(r)[-1] == "checks"
