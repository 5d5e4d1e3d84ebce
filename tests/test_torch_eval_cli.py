"""Evaluation through its entry points: liso_tpu_torch against liso_tpu on
an 8-frame SyntheticDataset at n_max 4096, grid 64 over 40 m (CPU).

- run_val with mined_db_predictor over the round-0 DB that each package
  mined (tests/test_torch_mining.py's loops), each DB through both
  packages' run_val: the same metric dict within METRIC_ATOL;
- LisoSelfTraining.validate (val set and val-on-train pass) with a random
  JAX detector state carried across by weights.load_detector_train_state:
  the port's predictions within BOX_ATOL of JAX's with the same kept set
  (the detector step's tolerance, tests/test_torch_detector_train.py), and
  the JAX predictions through the port's run_val give JAX's metric dict
  within METRIC_ATOL;
- DetectorTrainer.state_dict through utils/checkpoint: bitwise;
- eval_cli.main --fast-test --device cpu with each of its four predictors
  (tensorboard's and matplotlib's imports blocked: both writers fall back
  to no-op, the figures are skipped as the JAX package skips them).
"""
import sys

import numpy as np
import pytest
import torch

from liso_tpu.eval import run_val as jrv
from liso_tpu_torch.cli import eval_cli
from liso_tpu_torch.cli.common import DEFAULT_CFG
from liso_tpu_torch.data.pipeline import Prefetcher
from liso_tpu_torch.eval import run_val as trv
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.tracker.dbs import save_mined_boxes_db
from liso_tpu_torch.train import liso_loop as tloop
from liso_tpu_torch.train.detector_train import DetectorTrainer
from liso_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from liso_tpu_torch.utils.config import parse_config
from liso_tpu_torch.weights import load_detector_train_state
from test_torch_eval_metrics import assert_same_metrics
from test_torch_mining import _loops, _random_detector_state

torch.set_num_threads(1)
METRIC_ATOL = 1e-6
BOX_ATOL = 1e-4
SMOOTH_ITERS = 20
# eval_cli at the mining tests' size: grid 64 over 40 m
CLI_KV = [["data", "img_grid_size", "[64, 64]"],
          ["data", "bev_range_m", "[40.0, 40.0]"]]


def _batches(ds):
    return list(Prefetcher(ds, batch_size=1, shuffle=False, num_workers=0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' loops: round-0 DBs mined by each, the port's eval
    batches, and a random detector carried across."""
    tmp = tmp_path_factory.mktemp("liso_eval")
    jl, tl, jds, tds = _loops(tmp)
    for loop in (jl, tl):
        loop.mining_cfg_bootstrap = loop.mining_cfg_bootstrap._replace(
            smoothing_iters=SMOOTH_ITERS)
    jl.mine(jds)
    tl.mine(tds)
    jstate, port = _random_detector_state(jl, tds[0])
    jl.state = jstate
    load_detector_train_state(tl.trainer, port)
    tl.state = tl.trainer
    return {"loops": (jl, tl), "datasets": (jds, tds), "batches": _batches(tds),
            "dbs": {"jax": jl.mined_db, "port": tl.mined_db}, "tmp": tmp}


@pytest.mark.parametrize("miner", ["jax", "port"])
def test_run_val_on_mined_dbs_matches_jax(runs, miner):
    db = runs["dbs"][miner]
    assert sum(len(v["track_id"]) for v in db.values()) > 0
    batches = runs["batches"]
    got = trv.run_val(iter(batches), trv.mined_db_predictor(db), device="cpu")
    want = jrv.run_val(iter(batches), jrv.mined_db_predictor(db))
    assert got["AP_overall_overall_iou_bev@0.25"] > 0
    assert_same_metrics(got, want)


class _Recorder:
    """Wraps a loop's run_val: records each call's batches and predictions."""

    def __init__(self, module, monkeypatch):
        self.calls = []
        inner = module.run_val

        def recorded(batches, predict, **kw):
            call = {"kw": kw, "batches": [], "preds": []}
            self.calls.append(call)

            def predict_and_record(batch):
                out = predict(batch)
                call["batches"].append(batch)
                call["preds"].append({k: np.asarray(v) for k, v in out.items()})
                return out

            out = inner(batches, predict_and_record, **kw)
            call["metrics"] = dict(out)  # validate adds to the dict it gets
            return out

        monkeypatch.setattr(module, "run_val", recorded)


def test_validate_matches_jax(runs, monkeypatch):
    import liso_tpu.train.liso_loop as jloop_mod

    jl, tl = runs["loops"]
    jds, tds = runs["datasets"]
    jl.val_dataset, tl.val_dataset = jds, tds
    jrec, trec = _Recorder(jloop_mod, monkeypatch), _Recorder(tloop, monkeypatch)
    want = jl.validate(7, fast_test=True)
    got = tl.validate(7, fast_test=True)
    assert set(got) == set(want)
    assert any(k.startswith("val_on_train/mAP") for k in got)
    assert len(jrec.calls) == len(trec.calls) == 2  # val, val-on-train
    for jc, tc in zip(jrec.calls, trec.calls):
        assert len(jc["preds"]) == len(tc["preds"]) == 4
        for jp, tp in zip(jc["preds"], tc["preds"]):
            np.testing.assert_array_equal(tp["valid"], jp["valid"])
            assert tp["valid"].sum() > 0
            for k in ("pos", "dims", "rot", "probs"):
                np.testing.assert_allclose(tp[k], jp[k], atol=BOX_ATOL, rtol=0)
        # JAX's predictions through the port's run_val: JAX's metrics
        preds = iter(jc["preds"])
        kw = {k: v for k, v in jc["kw"].items() if k != "writer"}
        assert_same_metrics(
            trv.run_val(iter(jc["batches"]), lambda b: next(preds), device="cpu", **kw),
            jc["metrics"])


def test_detector_state_dict_round_trip_is_bitwise(tmp_path):
    bev = BevSetup((40.0, 40.0), (32, 32))
    g = torch.Generator().manual_seed(0)
    pts = (torch.rand(2, 256, 4, generator=g) - 0.5) * 36
    valid = torch.ones(2, 256, dtype=torch.bool)
    from liso_tpu_torch.ops.boxes import Boxes

    a = DetectorTrainer(bev, device="cpu", seed=0)
    for _ in range(2):  # moments, count, step and BN statistics move
        a.train_step(pts, valid, Boxes.empty(4, batch=(2,)))
    save_checkpoint(tmp_path, a.step, a)
    b = DetectorTrainer(bev, device="cpu", seed=1)
    params_before = [id(p) for p in b.params.values()]
    restore_checkpoint(tmp_path, 2, b)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"] == 2 and sa["optimizer"]["count"] == 2
    for part in ("model",):
        assert set(sa[part]) == set(sb[part])
        for k in sa[part]:
            assert torch.equal(sa[part][k], sb[part][k]), k
    for name in ("mu", "nu"):
        for k, v in sa["optimizer"][name].items():
            assert torch.equal(v, sb["optimizer"][name][k]), (name, k)
    # copied in place: the trainer's parameter tensors are the same objects
    assert [id(p) for p in b.params.values()] == params_before
    pa, pb = a.predict_step(pts, valid), b.predict_step(pts, valid)
    for f in ("pos", "dims", "rot", "probs", "valid"):
        assert torch.equal(getattr(pa, f), getattr(pb, f)), f
    bad = {**sa, "optimizer": {**sa["optimizer"], "mu": {}}}
    with pytest.raises(KeyError):
        b.load_state_dict(bad)


def _no_tb_no_plots(mp):
    """Block tensorboard (seconds to import) and matplotlib: both TB
    writers are no-ops and the summary plots are skipped."""
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    mp.setitem(sys.modules, "matplotlib", None)


def _cli(tmp_path, *extra):
    argv = ["-c", "bev_100m_512", "centerpoint", "liso", "--fast-test",
            "--device", "cpu", "--summary_dir", str(tmp_path)]
    for kv in CLI_KV:
        argv += ["-kv", *kv]
    return eval_cli.main(argv + list(extra))


@pytest.mark.parametrize("predictor", ["echo_gt", "flow_cluster_detector",
                                       "mined_db", "checkpoint"])
def test_eval_cli_predictors(runs, predictor, tmp_path, monkeypatch, capsys):
    _no_tb_no_plots(monkeypatch)
    if predictor == "mined_db":
        path = save_mined_boxes_db(runs["dbs"]["port"], tmp_path / "tracked")
        metrics = _cli(tmp_path, "--mined_db", str(path))
    elif predictor == "checkpoint":
        # the checkpoint of a trainer as eval_cli builds it, carrying the
        # random detector of the fixture; eval_cli's metrics are run_val's
        # on its predictions
        cfg = parse_config(DEFAULT_CFG, ["bev_100m_512", "centerpoint", "liso"],
                           CLI_KV)
        _, tl = runs["loops"]
        own = tloop.LisoSelfTraining(cfg, lambda db: None, None, tmp_path / "own",
                                     data_cfg=tl.data_cfg, device="cpu")
        own.trainer.load_state_dict(tl.trainer.state_dict())
        save_checkpoint(tmp_path / "ckpts", 5, own.trainer)
        metrics = _cli(tmp_path, "--load_checkpoint", str(tmp_path / "ckpts"))
        from liso_tpu_torch.cli.slim_cli import build_datasets

        _, val_ds, _ = build_datasets(cfg, True)
        want = trv.run_val(iter(_batches(val_ds)),
                           tloop.detector_predictor(own.trainer, "cpu"),
                           max_batches=4, device="cpu")
        assert_same_metrics({k: v for k, v in metrics.items() if "per_class" not in k},
                            {k: v for k, v in want.items() if "per_class" not in k},
                            atol=0.0)
    else:
        metrics = _cli(tmp_path, "--override_network", predictor)
    assert len(metrics) > 200
    assert all(np.isfinite(v) or np.isnan(v) for v in metrics.values())
    printed = dict(line.split(": ") for line in capsys.readouterr().out.splitlines()
                   if line.split(": ")[0] in metrics)
    assert set(printed) == set(metrics)
    assert all(float(printed[k]) == metrics[k] or np.isnan(metrics[k]) for k in metrics)
    if predictor == "echo_gt":  # tests/test_eval_metrics.py's oracle case
        assert metrics["AP_overall_overall_iou_bev@0.5"] > 0.99
        assert metrics["final_result/visible/detection_metrics/0_1000m/iou_bev/"
                       "mAP_overall_iou_bev"] > 0.99


def test_eval_cli_refuses_cpu_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_cli.main(["--override_network", "echo_gt", "--fast-test",
                       "--summary_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trv.run_val(iter([]), eval_cli.gt_echo_predictor)

