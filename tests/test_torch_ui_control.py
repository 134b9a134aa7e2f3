"""The port's hint edit list (ideepcolor_tpu_torch/ui/control.py) against
the JAX one, on the CPU: the scripted edits of tests/test_ui_control.py run
on both UIControl classes. Edit lists, coordinates, dense planes and table
boxes are equal; the table's ab values (the Lab of the hint colors, two f32
conversions: a = 500 (f(X/Xn) - f(Y)), where a few ulp of the cube roots
make a few 1e-5) within 1e-4."""

import numpy as np
import pytest
import torch

from ideepcolor_tpu.data import lab_gamut as jgamut
from ideepcolor_tpu.ops import hints as jhints
from ideepcolor_tpu.ui import control as jcontrol
from ideepcolor_tpu_torch.data import lab_gamut as tgamut
from ideepcolor_tpu_torch.ops import hints as thints
from ideepcolor_tpu_torch.ui import control as tcontrol

AB_TOL = 1e-4


def _pair(win=512, load=256, img=(512, 512)):
    out = []
    for mod in (jcontrol, tcontrol):
        c = mod.UIControl(win_size=win, load_size=load)
        c.setImageSize(img)
        out.append(c)
    return out


def _edit(e):
    return (e.pnt, e.color, e.user_color, e.width, e.ui_count)


def _same_state(j, t):
    assert [_edit(e) for e in t.userEdits] == [_edit(e) for e in j.userEdits]
    assert t.ui_count == j.ui_count
    jb, jv, jn = j.hint_table()
    tb, tv, tn = t.hint_table()
    assert tn == jn
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_allclose(tv, jv, atol=AB_TOL)
    for a, b in zip(t.get_input(), j.get_input()):
        np.testing.assert_array_equal(a, b)
    ju, tu = j.used_colors(), t.used_colors()
    assert (ju is None) == (tu is None)
    if ju is not None:
        np.testing.assert_array_equal(tu, ju)


SCRIPTS = {
    # test_add_select_move_erase
    "select_move_erase": [
        ("addPoint", (100, 100), (255, 0, 0), (250, 10, 10), 6.0),
        ("addPoint", (103, 103), (0, 255, 0), (0, 255, 0), 3.0),
        ("addPoint", (300, 300), (0, 0, 255), (0, 0, 255), 6.0),
        ("movePoint", (310, 290), (10, 20, 200), (12, 22, 202), 4.0),
        ("erasePoint", (101, 101)),
        ("erasePoint", (400, 400))],
    # test_used_colors_recency_and_dedup
    "used_colors": [
        ("addPoint", (50, 50), (1, 2, 3), (10, 20, 30), 6.0),
        ("addPoint", (200, 200), (4, 5, 6), (40, 50, 60), 6.0),
        ("addPoint", (350, 350), (7, 8, 9), (10, 20, 30), 6.0)],
    # test_dense_and_table_rasterization_agree, across the border too
    "rasterize": [
        ("addPoint", (128, 64), (200, 30, 30), (200, 30, 30), 6.0),
        ("addPoint", (400, 300), (30, 200, 30), (30, 200, 30), 4.0),
        ("addPoint", (2, 509), (30, 30, 200), (30, 30, 200), 9.0)],
    # test_update_color_after_select_then_table_reflects_it
    "update_color": [
        ("addPoint", (100, 100), (255, 0, 0), (255, 0, 0), 6.0),
        ("addPoint", (101, 101), (0, 0, 255), (0, 0, 255), 6.0),
        ("update_color", (0, 255, 0), (0, 255, 0))],
}


@pytest.mark.parametrize("img", [(512, 512), (512, 384), (300, 512)])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scripted_edits_give_the_same_state(script, img):
    """Every step of each script: the same return values, edit list,
    tables, dense planes and used colors, on a square and two letterboxed
    images."""
    j, t = _pair(img=img)
    for op, *args in SCRIPTS[script]:
        got = getattr(t, op)(*args)
        want = getattr(j, op)(*args)
        assert got == want, (op, args)
        _same_state(j, t)
    t.reset()
    j.reset()
    _same_state(j, t)
    assert t.ui_count == 0 and t.get_input()[1].sum() == 0


def test_table_rasterizes_to_the_dense_planes_and_hint_lab():
    """The port's table through its plain K1 covers exactly the dense
    mask, its ab is the Lab of the hint color (JAX's rgb2lab_1d within
    AB_TOL), and JAX's rasterizer gives the same planes."""
    j, t = _pair()
    for c in (j, t):
        c.addPoint((128, 64), (200, 30, 30), (200, 30, 30), 6.0)
        c.addPoint((400, 300), (30, 200, 30), (30, 200, 30), 4.0)
    im, mask = t.get_input()
    boxes, vals, n = t.hint_table()
    ab, m = thints.rasterize_hints(torch.from_numpy(boxes),
                                   torch.from_numpy(vals), n, 256)
    np.testing.assert_array_equal(m.numpy()[..., 0] > 0, mask[..., 0] > 0)
    jab, jm = jhints.rasterize_hints(*j.hint_table()[:2],
                                     np.int32(n), size=256)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(ab.numpy(), np.asarray(jab), atol=AB_TOL)
    ys, xs = np.nonzero(mask[..., 0])
    lab = jgamut.rgb2lab_1d(np.array([200, 30, 30], np.uint8))
    np.testing.assert_allclose(ab.numpy()[ys[0], xs[0]], lab[1:],
                               atol=AB_TOL)


def test_letterbox_mapping_and_overflow_table():
    """scale_point on a letterboxed image maps like JAX's; past MAX_HINTS
    edits the table keeps the first MAX_HINTS and the dense planes draw
    them all."""
    j, t = _pair(img=(512, 384))
    for x, y in ((256, 256), (0, 64), (511, 447), (17, 300)):
        for w in (0, 3, -3):
            assert t.scale_point(x, y, w) == j.scale_point(x, y, w)
    assert t.scale_point(256, 256, 0)[0] == 128
    for c in (j, t):
        for i in range(thints.MAX_HINTS + 4):
            c.addPoint((4 + 6 * (i % 80), 70 + 6 * (i // 80)),
                       (9 * (i % 28), 100, 50), (9 * (i % 28), 100, 50), 2)
    assert len(t.userEdits) == thints.MAX_HINTS + 4
    assert t.hint_table()[2] == thints.MAX_HINTS
    _same_state(j, t)


def test_lab_cache_is_bounded_and_reused():
    """The color->Lab cache holds at most 4096 colors, evicting before it
    inserts and keeping the current call's set."""
    tcontrol._hint_lab_cache.clear()
    tcontrol._lab_for_colors([(i % 256, i // 256, 7) for i in range(4000)])
    assert len(tcontrol._hint_lab_cache) == 4000
    keep = [(1, 2, 3), (250, 2, 3)]
    tcontrol._lab_for_colors(keep + [(i, 1, 255) for i in range(200)])
    assert len(tcontrol._hint_lab_cache) == 202
    assert all(c in tcontrol._hint_lab_cache for c in keep)
    lab = tgamut.rgb2lab_1d(np.array([250, 2, 3], np.uint8), device="cpu")
    np.testing.assert_allclose(tcontrol._hint_lab_cache[(250, 2, 3)], lab,
                               atol=1e-5)
