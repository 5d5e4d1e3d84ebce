"""The rounds loop's entry points on the CPU: liso_cli (a fresh run, a
resume, a finetune) and mining_cli (the bootstrap, a detector checkpoint,
one shard of two) at `-c bev_100m_512 centerpoint liso --fast-test --device
cpu` and the mining tests' grid (64 over 40 m): 8 train frames, 2 val
frames, n_max 4096; the fast test's rounds of 3 steps, 6 in all, a
validate and a checkpoint every 3 steps. For the CPU's sake the pre-NMS cap
is cut to PRE_MAX_BOXES boxes, and tensorboard and matplotlib are blocked
(no-op writers, no figures). The parity of what they run is held by
tests/test_torch_liso_rounds.py and tests/test_torch_mining.py."""
import functools
import shutil
import sys

import numpy as np
import pytest
import torch

from liso_tpu_torch.cli import liso_cli, mining_cli
from liso_tpu_torch.tracker.dbs import load_mined_boxes_db
from liso_tpu_torch.train import liso_loop as tloop
from liso_tpu_torch.utils import trace
from liso_tpu_torch.utils.checkpoint import latest_step

torch.set_num_threads(1)
PRE_MAX_BOXES = 64
# the spans each step of the rounds loop opens once
LOOP_SPANS = ("det.step", "det.wait", "det.paste", "det.h2d", "det.loss",
              "det.backward", "det.optimizer", "det.readback")
CLI_KV = [["data", "img_grid_size", "[64, 64]"],
          ["data", "bev_range_m", "[40.0, 40.0]"]]


def _cut(mp):
    """No tensorboard, no matplotlib, the pre-NMS cap at PRE_MAX_BOXES."""
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    mp.setitem(sys.modules, "matplotlib", None)
    mp.setattr(tloop, "DetectorTrainer", functools.partial(
        tloop.DetectorTrainer, pre_max_boxes=PRE_MAX_BOXES))
    mp.setattr(tloop, "PointPillarsTrainer", functools.partial(
        tloop.PointPillarsTrainer, pre_max_boxes=PRE_MAX_BOXES))


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    _cut(monkeypatch)


def _argv(summary_dir, *extra, network="centerpoint"):
    argv = ["-c", "bev_100m_512", network, "liso", "--fast-test",
            "--device", "cpu", "--summary_dir", str(summary_dir)]
    for kv in CLI_KV:
        argv += ["-kv", *kv]
    return argv + list(extra)


def _steps(ckpts):
    return sorted(int(p.name) for p in ckpts.iterdir() if p.name.isdigit())


def _mined_lines(out):
    return [ln for ln in out.splitlines() if "mining round" in ln]


@pytest.fixture(scope="module")
def fresh_run(tmp_path_factory):
    """liso_cli's fresh run, shared by the tests that resume from it."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("liso_cli")
    try:
        _cut(mp)
        seen = {}
        run = tloop.LisoSelfTraining.run

        def record(self, *a, **k):
            calls = {n: (trace.stats(n) or {"calls": 0})["calls"]
                     for n in LOOP_SPANS}
            out = run(self, *a, **k)
            seen["loop"] = self
            seen["losses"] = out
            seen["span_calls"] = {n: trace.stats(n)["calls"] - calls[n]
                                  for n in LOOP_SPANS}
            return out

        mp.setattr(tloop.LisoSelfTraining, "run", record)
        log_dir = liso_cli.main(_argv(tmp))
    finally:
        mp.undo()
    return log_dir, seen


def test_liso_cli_fresh_run(fresh_run):
    log_dir, seen = fresh_run
    loop = seen["loop"]
    assert (log_dir / "config.yml").exists()
    assert _steps(log_dir / "ckpts") == [3, 6]
    for r in (0, 1):
        assert (log_dir / f"mined_round_{r}" / "tracked.npz").exists()
    assert not (log_dir / "mined_round_2").exists()
    assert loop.round_idx == 2 and loop.trainer.step == 6
    assert seen["span_calls"] == {n: 6 for n in LOOP_SPANS}
    assert len(seen["losses"]) == 6 and np.all(np.isfinite(seen["losses"]))
    # drop_net_weights_every_nth_round 2: round 1 keeps the weights
    assert loop.trainer.count == 6
    db0 = load_mined_boxes_db(log_dir / "mined_round_0" / "tracked.npz")
    assert sum(len(v["track_id"]) for v in db0.values()) > 0


def test_liso_cli_resume(fresh_run, tmp_path, capsys):
    """--load_checkpoint of a log dir that holds step 3 and round 0's DBs:
    steps 4 and 5 (no boundary), then the checkpoint at 6."""
    src, _ = fresh_run
    run = tmp_path / "run"
    shutil.copytree(src / "ckpts" / "3", run / "ckpts" / "3")
    shutil.copy(src / "ckpts" / "format_version", run / "ckpts")
    shutil.copy(src / "config.yml", run / "config.yml")
    shutil.copytree(src / "mined_round_0", run / "mined_round_0")
    log_dir = liso_cli.main(_argv(tmp_path / "logs", "--load_checkpoint",
                                  str(run / "ckpts")))
    out = capsys.readouterr().out
    assert "resuming after step 3" in out and _mined_lines(out) == []
    assert _steps(log_dir / "ckpts") == [6]
    assert not list(log_dir.glob("mined_round_*"))


def test_liso_cli_finetune(fresh_run, tmp_path, monkeypatch, capsys):
    """--finetune keeps the weights only: the step and AdamW start at 0, the
    DBs are dropped, and the run mines from round 0 again."""
    src, fresh = fresh_run
    trained = fresh["loop"]
    seen = {}
    run = tloop.LisoSelfTraining.run

    def record(self, *a, **k):
        seen.update(step=self.trainer.step, count=self.trainer.count,
                    mined=self.mined_db, final=self._augm_db_final,
                    mu=max(float(m.abs().max()) for m in self.trainer.mu.values()),
                    start=k["start_step"])
        seen["same_weights"] = all(
            torch.equal(p, trained.trainer.params[n])
            for n, p in self.trainer.params.items())
        return run(self, *a, **k)

    monkeypatch.setattr(tloop.LisoSelfTraining, "run", record)
    log_dir = liso_cli.main(_argv(tmp_path, "--load_checkpoint",
                                  str(src / "ckpts"), "--finetune"))
    out = capsys.readouterr().out
    assert "finetune from step 6" in out
    assert seen == {"step": 0, "count": 0, "mined": None, "final": None,
                    "mu": 0.0, "start": 0, "same_weights": True}
    assert len(_mined_lines(out)) == 2
    assert _steps(log_dir / "ckpts") == [3, 6]


def test_mining_cli_bootstrap(tmp_path, capsys):
    log_dir = mining_cli.main(_argv(tmp_path))
    out = capsys.readouterr().out
    db = load_mined_boxes_db(log_dir / "mined_round_0" / "tracked.npz")
    assert sum(len(v["track_id"]) for v in db.values()) > 0
    assert "mined-box eval:" in out
    assert (log_dir / "tracked_sequence.gif").stat().st_size > 0


def test_mining_cli_detector_checkpoint(fresh_run, tmp_path, capsys):
    src, _ = fresh_run
    log_dir = mining_cli.main(_argv(tmp_path, "--load_checkpoint",
                                    str(src / "ckpts")))
    out = capsys.readouterr().out
    assert "restored detector checkpoint at step 6" in out
    assert (log_dir / "mined_round_1" / "tracked.npz").exists()
    assert not (log_dir / "mined_round_0").exists()


def test_mining_cli_one_shard_of_two(tmp_path):
    """--world_size 2 --worker_id 0 publishes its shard and does not wait
    for worker 1 (gather=False)."""
    log_dir = mining_cli.main(_argv(tmp_path, "--world_size", "2",
                                    "--worker_id", "0"))
    out = log_dir / "mined_round_0"
    assert (out / ".done_worker0").exists()
    assert (out / "tracked_worker0.npz").exists()
    assert not (out / "tracked.npz").exists()
    assert not (out / ".done_worker1").exists()


@pytest.mark.parametrize("cli", [liso_cli, mining_cli])
def test_clis_refuse_cpu_fallback(cli, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
    assert latest_step(tmp_path) is None


# Each network's preset through liso_cli at the fast test's counts (rounds
# of 3 steps, 6 in all, a validate and a checkpoint every 3 steps): each
# trains, mines with its own detector (round 1) and predicts.
PRESETS = {
    "transfusion": ("transfusion", [], "DetectorTrainer"),
    "pointpillars": ("pointpillars", [], "PointPillarsTrainer"),
    "pointrcnn": ("pointrcnn", [], "PointRCNNTrainer"),
    "centerpoint_non_baseline": (
        "centerpoint",
        [["network", "centerpoint", "use_baseline_parameters", "False"]],
        "DetectorTrainer"),
}


@pytest.mark.parametrize("preset", PRESETS)
def test_liso_cli_preset(preset, tmp_path, monkeypatch, capsys):
    network, kv, trainer_cls = PRESETS[preset]
    seen = {}
    validate = tloop.LisoSelfTraining.validate
    run = tloop.LisoSelfTraining.run

    def record(self, step, *a, **k):
        seen["metrics"] = validate(self, step, *a, **k)
        seen["loop"] = self
        return seen["metrics"]

    def record_run(self, *a, **k):
        seen["losses"] = run(self, *a, **k)
        return seen["losses"]

    monkeypatch.setattr(tloop.LisoSelfTraining, "validate", record)
    monkeypatch.setattr(tloop.LisoSelfTraining, "run", record_run)
    extra = [a for pair in kv for a in ["-kv", *pair]]
    log_dir = liso_cli.main(_argv(tmp_path, *extra, network=network))
    out = capsys.readouterr().out
    loop = seen["loop"]
    assert type(loop.trainer).__name__ == trainer_cls
    assert loop.cfg.network.name == network
    assert _mined_lines(out) == ["step 0: mining round 0",
                                  "step 3: mining round 1"]
    assert _steps(log_dir / "ckpts") == [3, 6]
    assert loop.trainer.step == 6
    assert len(seen["losses"]) == 6 and np.all(np.isfinite(seen["losses"]))
    assert any(k.startswith("mAP") for k in seen["metrics"])
    if preset == "centerpoint_non_baseline":
        assert loop.trainer.model.model.out_downsample_factor == 8
