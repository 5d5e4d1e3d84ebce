"""The control, the reference in the program's place at the next lower
precision, comes out not correct: fp8 operands for the bf16 stream (at a
small size on the CPU, and at the cell's size on the card), TF32 for the
fp32 train step (the card only: the CPU has no TF32)."""
import importlib
import tempfile
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.tests.small import BENCH, small_cell


def _control(name, device, small: bool, seed: int):
    if small:
        cell, config, traffic = small_cell(name)
    else:
        cell = harness.find_cell(name, BENCH)
        config = harness.load_json(harness.PB / "configs"
                                   / f"{cell['config']}.json")
        traffic = harness.load_json(harness.PB / "traffic"
                                    / f"{cell['traffic']}.json")
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    w = entry.Workload(config, traffic, seed, device,
                       Path(tempfile.mkdtemp()))
    w.make_inputs()
    nums = w.control_numbers()
    limits = traffic["limits"]
    return any(nums[k] > limits[k] for k in limits), nums


def test_stream_control_fails_small():
    failed, nums = _control("stream_b8", torch.device("cpu"), True, 11)
    assert failed, nums


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c["name"] for c in BENCH["workloads"]])
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 202, 2**31 + 303])
def test_control_fails_at_cell_size(name, seed, cuda_device):
    failed, nums = _control(name, cuda_device, False, seed)
    assert failed, nums
