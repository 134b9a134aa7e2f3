"""The port's GUI (ideepcolor_tpu_torch/ui/qt_gui.py) against the JAX GUI,
headless under the fake Qt of tests/_fake_qt.py, on the CPU.

Both GUIDraw widgets get the same seeded PNG, the teacher's weights at
load_size 64 (the JAX layout ``.npz``, read by both packages' loaders) and
the same events in the same order: an image load, clicks with colors (the
dist session's click+suggest click), a drag through the async session, a
palette pick, an erase, a wheel step, a session save and the dense fallback
past MAX_HINTS. The port's GUI composes its window on the device, its one
mode. The JAX GUI does too in the first pair (``IDEEPCOLOR_WIN_COMPOSE=
device``, ``IDEEPCOLOR_NET_CLICK=rgb``); in a second pair it composes it on
the host, its default (``IDEEPCOLOR_WIN_COMPOSE=host``, with its native
host library built into a temporary directory, ``_jax_host.py``). The JAX
GUI reads its image with cv2, whose INTER_CUBIC
resize runs without IPP here (the port copies OpenCV's own arithmetic; an
IPP build takes IPP's, see test_torch_frontend_io.py).

Frames. The net frames agree within the port's f32 frame bound, <= 1 LSB
on < 1e-3 of the pixels; there the two packages' f32 convs flip a byte on
1-2 of the 4096 pixels. The window frame is composed from the requantized
ab of the net frame, so a flipped net byte moves that pixel's ab by up to
0.5 and the 4x cubic upsample spreads it over a few dozen window pixels
(measured: 2 LSB on 1.1e-3 of them). So the window compose is held to the
bound on the same ab (the port's compose of JAX's ab against JAX's window),
and the end-to-end window frames to <= 2 LSB on < 5e-3. Tables: boxes and
counts equal, ab values within 1e-4 (the Lab of the hint colors from two
f32 conversions: a = 500 (f(X/Xn) - f(Y)), so a few ulp of the cube roots
make a few 1e-5; 3.05e-5 measured). The suggestion palette's sampled rows
come from each package's own random numbers (an accepted deviation since
the dist slice); its deterministic rows, the current color and the custom
swatch, are held.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _fake_qt  # noqa: E402

import torch  # noqa: E402
from ideepcolor_tpu.ops import host as jhost  # noqa: E402

from _jax_host import use_jax_native  # noqa: E402

torch.set_num_threads(2)
JAX_GET_LIB = jhost.get_lib
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEACHER = os.path.join(ROOT, "weights", "teacher.npz")
LOAD, WIN = 64, 256
FRAME_LSB, FRAME_SHARE = 1, 1e-3
WIN_LSB, WIN_SHARE = 2, 5e-3       # end to end, see the docstring


def _image(seed, H, W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * yy + c) * np.cos(5 * xx - 2 * c)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 12, (H, W, 3)),
                   0, 255).astype(np.uint8)


def _frames_agree(got, want, lsb=FRAME_LSB, share=FRAME_SHARE):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert d.max() <= lsb, d.max()
    assert np.mean(d != 0) < share, np.mean(d != 0)


def _windows_agree(jdraw, tdraw):
    """The net frames within the frame bound; the port's window compose of
    JAX's ab within it of JAX's window; the windows end to end within
    WIN_*."""
    from ideepcolor_tpu_torch.engine import pipeline as tP
    _frames_agree(tdraw.model.get_img_forward(),
                  jdraw.model.get_img_forward())
    jab = torch.from_numpy(np.array(jdraw.model.output_ab.transpose(1, 2, 0)))
    composed = tP.fullres_fuse(tdraw._dev_l_win, jab, tdraw._dev_win_rh,
                               tdraw._dev_win_rw).numpy()
    _frames_agree(composed, jdraw.result)
    _frames_agree(tdraw.result, jdraw.result, WIN_LSB, WIN_SHARE)


def _tables_agree(a, b):
    (ba, va, na), (bb, vb, nb) = a, b
    assert na == nb
    np.testing.assert_array_equal(ba, bb)
    np.testing.assert_allclose(va, vb, atol=1e-4)


def _gui_pair(tmp_path_factory, compose):
    """Yields (jax qt_gui, jax GUIDraw, port qt_gui, port GUIDraw, image
    path), both loaded with the same PNG; the JAX GUI composes its window
    on ``compose`` ("device" or "host"), the port's on the device."""
    try:
        import PyQt5
        if getattr(PyQt5, "__file__", None):    # the stand-in has none
            pytest.skip("real PyQt5 present; fake-Qt harness not applicable")
    except ImportError:
        pass
    import cv2
    saved = {k: sys.modules.get(k) for k in
             ("PyQt5", "PyQt5.QtCore", "PyQt5.QtGui", "PyQt5.QtWidgets")}
    ipp = cv2.ipp.useIPP()
    mp = pytest.MonkeyPatch()
    _fake_qt.install()
    cv2.ipp.setUseIPP(False)
    mp.setenv("IDEEPCOLOR_WIN_COMPOSE", compose)
    mp.setenv("IDEEPCOLOR_NET_CLICK", "rgb")
    if compose == "device":
        # the JAX GUI would build its native host library with g++ into
        # the shared package path from this worker; its numpy path serves
        mp.setattr(jhost, "get_lib", lambda: None)
    else:
        mp.setattr(jhost, "get_lib", JAX_GET_LIB)
        use_jax_native(mp, tmp_path_factory.mktemp("jax_hostops"))
    from ideepcolor_tpu import api as japi
    from ideepcolor_tpu.ui import qt_gui as jgui
    from ideepcolor_tpu_torch import api as tapi
    from ideepcolor_tpu_torch.ui import qt_gui as tgui
    from ideepcolor_tpu_torch.utils.imageio import encode_png

    path = str(tmp_path_factory.mktemp("gui") / "seeded.png")
    with open(path, "wb") as f:
        f.write(encode_png(_image(11, 150, 200)))
    jm = japi.ColorizeImageJax(Xd=LOAD)
    jm.prep_net(path=TEACHER)
    jd = japi.ColorizeImageJaxDist(Xd=LOAD)
    jd.prep_net(path=TEACHER)
    tm = tapi.ColorizeImageTorch(Xd=LOAD, device="cpu")
    tm.prep_net(path=TEACHER)
    td = tapi.ColorizeImageTorchDist(Xd=LOAD, device="cpu")
    td.prep_net(path=TEACHER)
    jdraw = jgui.GUIDraw(jm, dist_model=jd, load_size=LOAD, win_size=WIN)
    tdraw = tgui.GUIDraw(tm, dist_model=td, load_size=LOAD, win_size=WIN)
    jdraw.init_result(path)
    tdraw.init_result(path)
    assert jdraw._win_host == (compose == "host")
    yield jgui, jdraw, tgui, tdraw, path
    mp.undo()
    cv2.ipp.setUseIPP(ipp)
    for k, v in saved.items():
        if v is None:
            sys.modules.pop(k, None)
        else:
            sys.modules[k] = v


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    yield from _gui_pair(tmp_path_factory, "device")


@pytest.fixture(scope="module")
def host_pair(tmp_path_factory):
    yield from _gui_pair(tmp_path_factory, "host")


def test_image_load_gives_the_same_window_and_planes(pair):
    """The port's cubic window, gray window and load-size images are cv2's
    bit for bit, so the window geometry, the backdrop and the Lab planes
    agree; the initial frame within the frame bound."""
    _, jdraw, _, tdraw, _ = pair
    assert (tdraw.win_w, tdraw.win_h, tdraw.dw, tdraw.dh) == \
        (jdraw.win_w, jdraw.win_h, jdraw.dw, jdraw.dh) == (256, 192, 0, 32)
    np.testing.assert_array_equal(tdraw.gray_win, jdraw.gray_win)
    np.testing.assert_array_equal(tdraw.im_rgb, jdraw.im_rgb)
    np.testing.assert_allclose(tdraw.im_lab, jdraw.im_lab, atol=1e-4)
    np.testing.assert_allclose(tdraw.l_win, jdraw.l_win, atol=1e-4)
    assert tdraw.result.shape == (192, 256, 3)
    _windows_agree(jdraw, tdraw)


def test_scripted_session_frames_tables_and_palettes_agree(pair):
    """Clicks with colors (click+suggest in both), a drag of 20 motion
    events through the async session, a palette pick, an erase and a
    wheel step: after each edit the window frames agree, the hint tables
    agree and the used-colors palettes are equal."""
    _, jdraw, _, tdraw, _ = pair
    got = {"j": [], "t": []}
    for key, draw in (("j", jdraw), ("t", tdraw)):
        draw.suggest_colors.connect(
            lambda c, k=key: got[k].append(np.array(c)))

    def check(label):
        _windows_agree(jdraw, tdraw)
        _tables_agree(tdraw.uiControl.hint_table(),
                      jdraw.uiControl.hint_table())
        ju, tu = jdraw.uiControl.used_colors(), tdraw.uiControl.used_colors()
        assert (ju is None) == (tu is None), label
        if ju is not None:
            np.testing.assert_array_equal(tu, ju)

    clicks = [((128, 128), (200, 40, 40)), ((60, 100), (40, 180, 90)),
              ((200, 170), (30, 60, 200)), ((90, 200), (230, 200, 40))]
    for (x, y), color in clicks:
        for draw in (jdraw, tdraw):
            assert draw._can_fuse_suggest()
            draw.user_color = color
            draw.mousePressEvent(_fake_qt._Event(x, y, _fake_qt.Qt.LeftButton))
        check(f"click {x},{y}")
        # palette: 10 rows; row 0 the clicked pixel of the previous frame,
        # row 9 the custom swatch; rows 1-8 sampled (own random numbers)
        jp, tp = got["j"][-1], got["t"][-1]
        assert jp.shape == tp.shape == (10, 3)
        np.testing.assert_allclose(tp[0], jp[0], atol=1 / 255 + 1e-9)
        assert np.all(tp[9] == 0.5) and np.all(jp[9] == 0.5)
        assert np.all((tp >= 0) & (tp <= 1))
    assert len(tdraw.uiControl.userEdits) == len(clicks)

    for x in list(range(92, 112)):                 # drag: 20 motion events
        for draw in (jdraw, tdraw):
            draw.mouseMoveEvent(_fake_qt._Event(x, 200))
    assert tdraw._async.frames_submitted == 20
    assert tdraw._async.pending == 0               # fetched synchronously
    assert tdraw.uiControl.userEdits[-1].pnt == (111, 200)
    check("drag")
    drag_frame = tdraw.result.copy()
    tdraw.compute_result()                         # the sync path agrees
    np.testing.assert_array_equal(drag_frame, tdraw.result)
    jdraw.compute_result()

    for draw in (jdraw, tdraw):                    # palette pick
        draw.pos = _fake_qt.QPoint(111, 200)
        draw.set_color((30, 180, 60))
    check("palette pick")
    for draw in (jdraw, tdraw):                    # erase
        draw.mousePressEvent(_fake_qt._Event(60, 100,
                                             _fake_qt.Qt.RightButton))
    assert len(tdraw.uiControl.userEdits) == len(clicks) - 1
    check("erase")
    for draw in (jdraw, tdraw):                    # wheel
        draw.ui_mode = 'none'
        draw.wheelEvent(_fake_qt._Event(0, 0, delta=120))
    assert tdraw.brushWidth == jdraw.brushWidth
    # the window frame equals the reference host recipe: cubic ab resize
    # to the window + window L + lab2rgb (ref ui/gui_draw.py:280-284)
    import cv2
    from ideepcolor_tpu_torch.api.colorize import lab2rgb_transpose
    ab = tdraw.model.output_ab.transpose(1, 2, 0).astype(np.float32)
    ab_win = cv2.resize(ab, (tdraw.win_w, tdraw.win_h),
                        interpolation=cv2.INTER_CUBIC)
    want = lab2rgb_transpose(tdraw.l_win[None], ab_win.transpose(2, 0, 1),
                             device="cpu")
    d = np.abs(tdraw.result.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_session_save_writes_the_same_files(pair, tmp_path):
    """save_result writes the reference's files: the .npy planes equal JAX's
    (im_l within 1e-4, the hint mirrors' ab within the tables' 1e-4, the
    mask exactly),
    the PNGs decode to the frames they were written from and agree with
    JAX's."""
    import cv2
    from ideepcolor_tpu_torch.utils.imageio import read_image
    _, jdraw, _, tdraw, _ = pair
    for draw in (jdraw, tdraw):
        draw.user_color = (200, 40, 40)
        draw.mousePressEvent(_fake_qt._Event(150, 90, _fake_qt.Qt.LeftButton))
    dirs = {}
    for key, draw in (("j", jdraw), ("t", tdraw)):
        d = tmp_path / key
        d.mkdir()
        draw.image_file = str(d / "img.png")
        draw.save_result()
        (out,) = [p for p in d.iterdir() if p.is_dir()]
        dirs[key] = out
    j, t = dirs["j"], dirs["t"]
    names = {"im_l.npy", "im_ab.npy", "im_mask.npy", "ours.png",
             "ours_fullres.png", "input_fullres.png", "input.png",
             "input_ab.png", "input_mask.png"}
    assert {p.name for p in t.iterdir()} == names
    np.testing.assert_allclose(np.load(t / "im_l.npy"),
                               np.load(j / "im_l.npy"), atol=1e-4)
    np.testing.assert_allclose(np.load(t / "im_ab.npy"),
                               np.load(j / "im_ab.npy"), atol=1e-4)
    np.testing.assert_array_equal(np.load(t / "im_mask.npy"),
                                  np.load(j / "im_mask.npy"))
    assert np.load(t / "im_mask.npy").sum() > 0
    np.testing.assert_array_equal(read_image(str(t / "ours.png")),
                                  tdraw.result)
    for name in ("ours.png", "ours_fullres.png", "input_fullres.png",
                 "input.png", "input_ab.png"):
        want = cv2.cvtColor(cv2.imread(str(j / name)), cv2.COLOR_BGR2RGB)
        _frames_agree(read_image(str(t / name)), want)
    np.testing.assert_array_equal(
        read_image(str(t / "input_mask.png")),
        cv2.cvtColor(cv2.imread(str(j / "input_mask.png")),
                     cv2.COLOR_BGR2RGB))
    assert tdraw.timer.samples["click_to_frame"]


def test_more_edits_than_table_slots_fall_back_to_dense(pair):
    """Past MAX_HINTS edits both GUIs rasterize ALL of them through the
    dense click (ref ui/ui_control.py:177): the mask mirrors cover every
    edit and the frames agree."""
    from ideepcolor_tpu_torch.ops.hints import MAX_HINTS
    _, jdraw, _, tdraw, _ = pair
    for draw in (jdraw, tdraw):
        draw.uiControl.reset()
        per_row = max((draw.win_w - 20) // 6, 1)
        for i in range(MAX_HINTS + 6):
            x = 10 + 6 * (i % per_row)
            y = 40 + 6 * (i // per_row)
            draw.uiControl.addPoint((x, y), (200, 30, 30), (200, 30, 30), 2)
        assert len(draw.uiControl.userEdits) > MAX_HINTS
        draw.compute_result()
    im, mask = tdraw.uiControl.get_input()
    np.testing.assert_array_equal(tdraw.im_mask0[0] > 0, mask[..., 0] > 0)
    np.testing.assert_array_equal(tdraw.im_mask0, jdraw.im_mask0)
    _windows_agree(jdraw, tdraw)
    for draw in (jdraw, tdraw):
        draw.reset()
    assert len(tdraw.uiControl.userEdits) == 0
    assert tdraw.user_color == (128, 128, 128)
    _windows_agree(jdraw, tdraw)


def test_main_window_wiring(pair):
    """GUIDesign: a pad click reaches the gamut widget (its mask) and the
    suggestion palette; a gamut pick recolors; the R hotkey resets; the
    gamut hover and palette drag rules of the reference hold."""
    from ideepcolor_tpu_torch import api as tapi
    _, _, tgui, _, path = pair
    student = os.path.join(ROOT, "weights", "student_w025.npz")
    model = tapi.ColorizeImageTorch(Xd=LOAD, device="cpu")
    model.prep_net(path=student)
    dist = tapi.ColorizeImageTorchDist(Xd=LOAD, device="cpu")
    dist.prep_net(path=student)
    win = tgui.GUIDesign(model, dist_model=dist, img_file=path,
                         load_size=LOAD, win_size=WIN)
    assert win.gamutWidget.device.type == "cpu"
    draw = win.drawWidget
    for x in (128, 60):
        draw.mousePressEvent(_fake_qt._Event(x, 128, _fake_qt.Qt.LeftButton))
    assert win.gamutWidget.mask is not None
    assert win.gamutWidget.mask.shape == (221, 221)
    assert win.customPalette.colors.shape == (10, 3)
    # used colors are emitted before the click adds its point (reference
    # order): the second click shows the first one's color
    assert win.usedPalette.colors.shape == (1, 3)
    before = draw.result.copy()
    ys, xs = np.nonzero(win.gamutWidget.mask)
    win.gamutWidget.update_ui(_fake_qt.QPoint(int(xs[len(xs) // 3]),
                                              int(ys[len(ys) // 3])))
    assert not np.array_equal(before, draw.result)
    assert win.visWidget.result is draw.result

    class _K:
        def key(self):
            return _fake_qt.Qt.Key_R
    win.keyPressEvent(_K())
    assert len(draw.uiControl.userEdits) == 0

    g = tgui.GUIGamut(gamut_size=110, device="cpu")
    picked = []
    g.update_color.connect(picked.append)
    g.set_gamut(50.0)
    ys, xs = np.nonzero(g.mask)
    inside = (int(xs[0]), int(ys[0]))
    g.mouseMoveEvent(_fake_qt._Event(*inside))          # hover: no pick
    assert picked == []
    g.mousePressEvent(_fake_qt._Event(*inside, _fake_qt.Qt.LeftButton))
    g.mouseMoveEvent(_fake_qt._Event(*inside))          # held: picks
    g.mouseReleaseEvent(_fake_qt._Event(*inside))
    g.mouseMoveEvent(_fake_qt._Event(*inside))
    assert len(picked) == 2
    p = tgui.GUIPalette(grid_sz=(3, 1))
    p.set_colors(np.tile(np.linspace(0, 1, 8)[:, None], (1, 3)))
    assert len(p.colors) == 3
    p.update_color.connect(win.gamutWidget.set_ab)
    win.gamutWidget.pos = None
    p.mousePressEvent(_fake_qt._Event(8 + 26, 8, _fake_qt.Qt.LeftButton))
    assert p.id == 1 and win.gamutWidget.pos is not None



def test_device_compose_session_matches_jax_host_gui(host_pair):
    """The port's GUI, in its one mode, against the JAX GUI with
    IDEEPCOLOR_WIN_COMPOSE=host, the JAX default (the net frame read back,
    the window composed by its native host runtime): after the image load,
    clicks with colors (net_forward_table_win_suggest against
    net_forward_table_suggest_host), a drag (window frames from the async
    session against JAX's composed in _fetch_async), a palette pick and an
    erase (net_forward_table_win against net_forward_table_win_host) the
    net frames agree within the frame bound, the port's device compose of
    JAX's ab agrees with JAX's host window within it, the windows end to
    end within WIN_*, palette row 0 is equal, and the hint tables and
    mirrors agree."""
    _, jdraw, _, tdraw, _ = host_pair
    assert not hasattr(tdraw, "_win_host")
    np.testing.assert_allclose(tdraw.l_win, jdraw._host_l_win_pad[
        :tdraw.win_h, :tdraw.win_w, 0], atol=1e-4)
    palettes = {"j": [], "t": []}
    for key, draw in (("j", jdraw), ("t", tdraw)):
        draw.suggest_colors.connect(
            lambda c, k=key: palettes[k].append(np.array(c)))

    def check(label):
        _windows_agree(jdraw, tdraw)
        _tables_agree(tdraw.uiControl.hint_table(),
                      jdraw.uiControl.hint_table())
        np.testing.assert_array_equal(tdraw.im_mask0, jdraw.im_mask0)
        np.testing.assert_allclose(tdraw.im_ab0, jdraw.im_ab0, atol=1e-4)

    check("load")
    for (x, y), color in (((128, 128), (200, 40, 40)),
                          ((60, 100), (40, 180, 90)),
                          ((200, 170), (30, 60, 200))):
        for draw in (jdraw, tdraw):
            assert draw._can_fuse_suggest()
            draw.user_color = color
            draw.mousePressEvent(_fake_qt._Event(x, y, _fake_qt.Qt.LeftButton))
        check(f"click {x},{y}")
        jp, tp = palettes["j"][-1], palettes["t"][-1]
        assert tp.shape == jp.shape == (10, 3)
        np.testing.assert_array_equal(tp[0], jp[0])
    for x in range(200, 210):                      # drag: 10 motion events
        for draw in (jdraw, tdraw):
            draw.mouseMoveEvent(_fake_qt._Event(x, 170))
    assert tdraw._async.frames_submitted == 10 and tdraw._async.pending == 0
    check("drag")
    drag_frame = tdraw.result.copy()
    tdraw.compute_result()                         # the sync window click
    np.testing.assert_array_equal(drag_frame, tdraw.result)
    jdraw.compute_result()
    for draw in (jdraw, tdraw):                    # palette pick
        draw.pos = _fake_qt.QPoint(209, 170)
        draw.set_color((30, 180, 60))
    check("palette pick")
    for draw in (jdraw, tdraw):                    # erase
        draw.mousePressEvent(_fake_qt._Event(60, 100,
                                             _fake_qt.Qt.RightButton))
    assert len(tdraw.uiControl.userEdits) == 2
    check("erase")
