"""The control: the reference in the precision a step below the one the
configuration states, put in the program's place, fails the check. The
bfloat16 control of the TF32 batch cell runs on the CPU; TF32 exists only
on the card, so the float32 cells' TF32 controls are card tests."""

import pytest

from conftest import SMALL
from harness.spec import Cell


def _control(cell, prec, device, seed, actions, small=True):
    c = Cell(cell)
    if small:
        for part, values in SMALL[cell].items():
            getattr(c, part).update(values)
    drv = c.driver().Driver(c, c.model(), c.entry(), seed, device)
    nums = drv.control(actions, prec, c.limits)
    return any(v["value"] is not None and v["value"] > v["limit"]
               for v in nums.values()), nums


def test_bfloat16_control_fails_the_batch_check():
    failed, nums = _control("siggraph.batch", "bfloat16", "cpu", 3, 4)
    assert failed, nums


@pytest.mark.card
@pytest.mark.parametrize("cell", ["siggraph.click", "caffe_dist.click"])
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_tf32_control_fails_the_click_check(card, cell, seed):
    # the cell's own image and sizes; 640 actions sample about 20 of them
    failed, nums = _control(cell, "tf32", "cuda", seed, 640, small=False)
    assert failed, nums


@pytest.mark.card
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_bfloat16_control_fails_the_batch_check_on_the_card(card, seed):
    # 160 batches sample about 10 of them
    failed, nums = _control("siggraph.batch", "bfloat16", "cuda", seed, 160,
                            small=False)
    assert failed, nums
