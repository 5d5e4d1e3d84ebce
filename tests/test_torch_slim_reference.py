"""The port's SLIM train step against the benchmark's plain reference
(portbench/reference/slim_step.py: fp32, exact 1-NN, Kabsch by SVD,
autograd), on the CPU at grid 64 over 40 m, at most 4096 points a frame and
2 RAFT iterations, slim_liso.

The step is reached as the benchmark reaches it: `SlimExperiment.
train_batch` on the batches of `SlimExperiment.train_loader`, three steps
from one seeded state whose step counter stands at the end of the warm-up.
The loss terms of step 1, step 1's gradient, the state and RMSprop's nu
after step 3, the dynamicness threshold after step 3 and step 1's flow are
compared (`portbench/entries/slim_step.py`'s numbers). A negative case: the
reference with RAFT's convolutions in bf16 in the program's place fails at
least one of the same tolerances.
"""
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from portbench.entries.slim_step import Workload
from portbench.tests.small import small_cell

torch.set_num_threads(1)
SEED = 2**31 + 5

# Each tolerance sits above what the program reads at this size (on this
# seed and others) and what one fp32 reference reads against another that
# differs from it only in rounding, and below what bf16 convolutions read.
TOL = {
    # both sides read the same sample files: any gap is a fault
    "data_gap": 0.0,
    # step 1's loss terms, from the same state and batch on both sides: the
    # program reads about 1e-6; bf16 convs 4.8e-3-1.8e-2
    "loss_rel": 1e-4,
    # up to 6.8e-4, and the reference with the port's correlation backward
    # (K5's rounding points) 4.5e-4-7.5e-4 against its own; bf16 convs 6e-2
    "grad_gap": 1e-2,
    # the median leaf after 3 steps: up to 8.7e-4; bf16 convs 4e-3-4.5e-3
    "update_gap": 2.5e-3,
    # the threshold after 3 steps, by the cumulative improvement curve it
    # is the least of (the largest gap over the curve's range): up to
    # 3.2e-2, the reference with K5's rounding points up to 3.6e-2; bf16
    # convs 0.157-0.194
    "thr_gap": 8e-2,
    # step 1's last-iteration flow, m: the CPU runs the same plain ops on
    # both sides (0 read); bf16 convs 0.049-0.058 m
    "flow_m": 1e-2,
}


@pytest.fixture(scope="module")
def stepped():
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "tensorboard", None)  # TBFactory's no-op writers
    try:
        _, config, traffic = small_cell("slim_train_b1")
        traffic.update(frames=5, warmup_steps=0)
        w = Workload(config, traffic, SEED, torch.device("cpu"),
                     Path(tempfile.mkdtemp()))
        w.setup()
        w.close_program()
        yield w, w.reference_run("fp32")
    finally:
        mp.undo()


def test_train_step_matches_the_reference(stepped):
    w, reference = stepped
    nums = w.numbers(w.program_side(), reference)
    assert set(nums) == set(TOL)
    over = {k: v for k, v in nums.items() if not v <= TOL[k]}
    assert not over, (nums, w.details(w.program_side(), reference))


def test_the_step_was_past_warm_up_and_moved_the_state(stepped):
    w, reference = stepped
    assert w.first_step == 2000
    moved = [k for k in w.prog_after if k.startswith("nu.")
             and float(w.prog_after[k].abs().max()) > 0]
    assert moved and w.prog_thr != 0.5  # the threshold left its start


def test_bf16_convolutions_fail_a_tolerance(stepped):
    w, reference = stepped
    nums = w.numbers(w.reference_run("bf16conv"), reference)
    assert any(v > TOL[k] for k, v in nums.items()), nums
