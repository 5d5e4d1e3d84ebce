"""The harness finds every cell's configuration, traffic mix, entry and
per-layer readers by name, and BENCHMARK.json keeps the contract's
shape."""
import importlib
import re

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_every_cell_resolves_by_name():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        cfg = configs[cell["config"]]
        assert (harness.ROOT / cfg["file"]).is_file()
        traffic = harness.load_json(harness.PB / "traffic"
                                    / f"{cell['traffic']}.json")
        entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
        assert hasattr(entry, "Workload")
        assert cell["chips"] == 1
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == set(configs)


def test_every_per_layer_metric_has_a_reader():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells


def test_names_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["workloads"] + BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_cell_metrics_filter():
    per = harness.cell_metrics(BENCH, "stream_b8", "per_layer")
    assert per and all("stream_b8" in m["workloads"] for m in per)
