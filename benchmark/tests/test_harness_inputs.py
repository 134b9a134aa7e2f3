"""Traffic from the seed: one seed gives the same inputs every time, two
seeds give different ones of the same sizes and counts."""

import numpy as np
import torch

from conftest import SMALL
from harness import inputs
from harness.spec import Cell

BIG = 2 ** 31 + 12345


def _drag_tables(seed, n=25):
    cell = Cell("siggraph.click")
    drv = cell.driver()
    s = drv.Script(inputs.rng(seed, "script"), 256, cell.mix)
    return [s.next() for _ in range(n)]


def test_drag_script_repeats_and_differs():
    a, b, c = _drag_tables(BIG), _drag_tables(BIG), _drag_tables(BIG + 1)
    for x, y in zip(a, b):
        assert all(np.array_equal(p, q) for p, q in zip(x, y))
    assert any(not np.array_equal(x[0], z[0]) for x, z in zip(a, c))
    # the live count follows the action index alone: 1 hint per 10 actions
    assert [t[2] for t in a] == [i // 10 + 1 for i in range(25)]
    assert [t[2] for t in c] == [t[2] for t in a]


def test_drag_restarts_after_max_hints():
    cell = Cell("siggraph.click")
    s = cell.driver().Script(inputs.rng(1, "script"), 256, cell.mix)
    counts = [s.next()[2] for _ in range(330)]
    assert max(counts) == cell.mix["max_hints"] and counts[320] == 1


def test_boxes_stay_inside_the_frame():
    for boxes, _v, n in _drag_tables(7, 200):
        assert (boxes[:n] >= 0).all() and (boxes[:n] <= 255).all()


def test_images_repeat_and_differ():
    im = lambda s: inputs.image(inputs.rng(s, "image"), 100, 80)  # noqa
    assert np.array_equal(im(BIG), im(BIG))
    assert not np.array_equal(im(BIG), im(BIG + 1))
    assert im(BIG).shape == (100, 80, 3) and im(BIG).dtype == np.uint8
    dev = lambda s: inputs.images_device(s, 2, 32, torch, "cpu")  # noqa
    assert torch.equal(dev(BIG), dev(BIG))
    assert not torch.equal(dev(BIG), dev(BIG + 1))


def test_batch_inputs_repeat_and_differ():
    cell = Cell("siggraph.batch")
    cell.mix.update(SMALL["siggraph.batch"]["mix"])
    drv = cell.driver().Driver(cell, cell.model(), cell.entry(), BIG, "cpu")

    def draw(seed):
        r = inputs.rng(seed, "tables")
        return [drv._inputs(i, r) for i in range(5)]

    a, b, c = draw(BIG), draw(BIG), draw(BIG + 1)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert any(not np.array_equal(x["boxes"], z["boxes"])
               for x, z in zip(a, c))
    assert all(x["boxes"].shape == z["boxes"].shape for x, z in zip(a, c))
