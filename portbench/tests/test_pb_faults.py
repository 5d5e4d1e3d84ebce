"""With the timed path broken underneath, a run comes out not correct:
a step that returns its state unchanged, half of the batch left out, and
an answer altered where it is produced (at a small size on the CPU; the
harness's look for a chip is skipped)."""
import pytest

from portbench import faults
from portbench.tests.small import run_small


@pytest.mark.parametrize("kind", faults.KINDS)
def test_stream_fault_is_caught(kind, tmp_path):
    with faults.plant("stream", kind):
        r = run_small("stream_b8", tmp=tmp_path)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("kind", faults.KINDS)
def test_round_fault_is_caught(kind, tmp_path, no_tensorboard):
    with faults.plant("round_step", kind):
        r = run_small("round_step_b2", tmp=tmp_path)
    assert not r["correct"], r["checks"]
