"""A run with its timed path broken underneath comes out not correct:
each fault a cell can have, planted under the driver, in a whole run on
the CPU at a small size (the look for a card is skipped)."""

import pytest

from conftest import SMALL
from harness import runner

FAULTS = [
    # a step that returns its state unchanged: the previous answer again
    ("siggraph.click", "stale"), ("caffe_dist.click", "stale"),
    ("siggraph.batch", "stale"),
    # an answer altered where it is produced
    ("siggraph.click", "altered"), ("caffe_dist.click", "altered"),
    ("siggraph.batch", "altered"),
    # half of the batch left out: its frames are the other half's
    ("siggraph.batch", "half"),
]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault):
    res = runner.run(cell, 2 ** 31 + 7, 1.5, False, device="cpu",
                     fault=fault, overrides=SMALL[cell])
    assert res["attempted"] > 0
    assert res["correct"] is False, res["check"]
