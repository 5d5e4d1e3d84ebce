"""Shared fixtures of the benchmark's own tests (CPU; the `cuda`-marked
ones need the card and skip elsewhere)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    import torch

    # a few threads a test process: several run side by side
    torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def no_tensorboard(monkeypatch):
    """The rounds loop's TBFactory falls back to no-op writers."""
    monkeypatch.setitem(sys.modules, "tensorboard", None)
