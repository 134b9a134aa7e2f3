"""The bytes counted for K1 and K2 against the kernel table's bounds:
0.000235 ms for K1 at one table of 10 hints at 256 x 256, 0.000450 ms for
K2's fused entry and 0.002348 ms for eight batched frames at 256 x 256."""

import pytest

from harness import peaks
from harness.spec import Cell

CELL = Cell("siggraph.click")


class _Tr:
    def __init__(self, s):
        self.s = s

    def kernel_s(self, *names):
        return self.s


def _ms(nbytes):
    return nbytes / peaks.HBM_BYTES_PER_S * 1e3


def test_k1_bound_at_one_table():
    k1 = CELL.metric("k1_roofline_pct.click")
    work = [{"tables": [10], "size": 256}]
    assert round(_ms(k1.nbytes(work)), 6) == 0.000235


def test_k2_bounds_fused_and_batched():
    k2 = CELL.metric("k2_roofline_pct.click")
    nb, ops = k2.work_of([{"size": 256, "k2_fused_frames": 1}])
    assert round(_ms(nb), 6) == 0.000450
    assert ops / peaks.FLOPS["float32"] < nb / peaks.HBM_BYTES_PER_S
    nb, _ = k2.work_of([{"size": 256, "k2_batch_frames": 8}])
    assert round(_ms(nb), 6) == 0.002348


def test_roofline_share_and_nothing_to_read():
    k2 = CELL.metric("k2_roofline_pct.click")
    work = [{"size": 256, "k2_fused_frames": 1}] * 4
    least = 4 * 23 * 256 * 256 / peaks.HBM_BYTES_PER_S
    ctx = {"trace": _Tr(2 * least), "work": work}
    assert k2.read(ctx) == pytest.approx(50.0)
    assert k2.read({"trace": _Tr(0.0), "work": work}) is None
    k1 = CELL.metric("k1_roofline_pct.click")
    assert k1.read({"trace": _Tr(1e-3), "work": [{"tables": [],
                                                  "size": 256}]}) is None
