"""`slim_train_b1`: planted faults make a small CPU run not correct, K5's
and K6's bytes and operations against hand counts, the configuration file
against the presets it names, and the cell's readers with nothing to
read."""
from types import SimpleNamespace

import pytest
import torch

from portbench import slim_costs, slim_faults
from portbench.tests.small import BENCH, run_small


@pytest.mark.parametrize("kind", slim_faults.KINDS)
def test_slim_fault_is_caught(kind, tmp_path, no_tensorboard):
    with slim_faults.plant(kind):
        r = run_small("slim_train_b1", tmp=tmp_path)
    assert not r["correct"], r["checks"]


def test_corr_bwd_cost_by_hand():
    # pixel A at (0, 0), pixel B at (10, 2); two 8 x 8 levels, radius 3:
    # level 0: A rows -3..4 -> 5, cols 5 (25); B rows 7..14 -> 1, cols -1..6
    # -> 7 (7); level 1 (coords / 2): A 25; B (5, 1): rows 2..9 -> 6, cols
    # -2..5 -> 6 (36)
    coords = torch.tensor([[[0.0, 10.0], [0.0, 2.0]]])
    levels = SimpleNamespace(shapes=((8, 8), (8, 8)))
    assert slim_costs.in_range_taps(coords, levels.shapes, 3) == 93
    f0 = torch.zeros(1, 2, 32, dtype=torch.bfloat16)
    f1cat = torch.zeros(1, 128, 32, dtype=torch.bfloat16)
    g = torch.zeros(1, 128, 2)
    nbytes, nops = slim_costs.corr_bwd_cost(f0, f1cat, coords, g, levels, 3)()
    # f0, f1cat bf16 in; coords, g fp32 in; df0, df1 fp32 out
    assert nbytes == 128 + 8192 + 16 + 1024 + 256 + 16384
    assert nops == 4 * 32 * 93


def test_knn_cost_by_hand():
    refs = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [2, 0, 0], [10, 0, 0]]])
    q = torch.tensor([[[0.9, 0, 0], [5, 0, 0], [6, 0, 0], [7, 0, 0]]])
    q_valid = torch.tensor([[True, True, True, False]])
    r_valid = torch.ones(1, 4, dtype=torch.bool)
    # (0.9): nearest 1 at 0.1, only x = 1 within the stop radius; (5):
    # nearest 2 at 3, only x = 2; (6): 2 and 10 tie at 4, both; (7) invalid
    d = slim_costs.exact_nn_sqr(q, refs, q_valid, r_valid)
    assert torch.allclose(d[0, :3], torch.tensor([0.01, 9.0, 16.0],
                                                 dtype=torch.float64))
    nbytes, nops = slim_costs.knn_cost(q, refs, q_valid, r_valid)()
    assert nops == 6 * (1 + 1 + 2)
    assert nbytes == 48 + 48 + 4 + 4 + 32


def test_configuration_states_the_presets():
    from liso_tpu_torch.cli.common import DEFAULT_CFG
    from liso_tpu_torch.utils.config import parse_config

    from portbench import harness

    cell = harness.find_cell("slim_train_b1", BENCH)
    config = harness.load_json(harness.PB / "configs" / f"{cell['config']}.json")
    cfg = parse_config(DEFAULT_CFG, config["presets"])
    g, r = config["grid_size"], config["bev_range_m"]
    assert tuple(cfg.data.img_grid_size) == (g, g)
    assert tuple(cfg.data.bev_range_m) == (r, r)
    assert int(cfg.SLIM.model.num_iters) == config["slim"]["num_iters"]
    assert int(cfg.SLIM.iterations.train) == config["train"]["train_steps"]
    assert int(cfg.SLIM.learning_rate.warm_up.step_length) == \
        config["train"]["warmup_steps"]
    assert config["reduced"] == []


@pytest.mark.parametrize("name", ["device_idle.slim", "mfu.slim",
                                  "forward_ms.slim", "loss_ms.slim",
                                  "backward_host_ms.slim", "knn_roofline.slim",
                                  "corr_bwd_roofline.slim"])
def test_readers_find_nothing_in_an_untraced_run(name):
    from portbench import harness

    record = harness.RunRecord(SimpleNamespace())
    assert harness.load_reader(name)(record) is None
