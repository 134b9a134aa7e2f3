"""pytest settings of the benchmark's own tests (``benchmark/tests``):
the harness's directory and the checkout's root on the path, and the
``card`` marker for tests that need a CUDA device, which skip elsewhere."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, at run time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# small sizes for whole runs of a cell on the CPU
SMALL = {
    "siggraph.click": {"config": {"Xd": 64},
                       "mix": {"image_hw": [250, 190], "warmup_actions": 2,
                               "sample_every": 2, "trace_actions": 4}},
    "caffe_dist.click": {"config": {"Xd": 64},
                         "mix": {"image_hw": [250, 190], "warmup_actions": 2,
                                 "sample_every": 2, "trace_actions": 4}},
    "siggraph.batch": {"mix": {"size": 64, "batch": 4, "pool_batches": 2,
                               "warmup_actions": 1, "sample_every": 2}},
}
