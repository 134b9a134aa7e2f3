"""The host-composed clicks of the port (the abq and ``*_host`` clicks, the
packed-row click+suggest program, the host-rasterized hint mirrors, the
server's ``IDEEPCOLOR_NET_CLICK`` and the loader's host Lab) against the
JAX package's, on the CPU at Xd=64, on the same numpy-seeded inputs.

Both packages' host runtimes are native here (the JAX library built from
its own source into a temporary directory, ``_jax_host.py``), so a host
compose of the same payload gives the same bytes.

Bounds. The abq payload steps 0.863 ab units; the two packages' f32 convs
differ in the last bits, and a prediction that lies within that of a
rounding edge lands one step apart: payloads equal but one step on at most
``PAYLOAD_SHARE`` of the values (the half payload's 2x2 mean adds its own
summation order). A payload step moves a host-composed pixel by about 1
LSB, so the frames composed from the two packages' payloads agree within 1
LSB on at most ``PAYLOAD_SHARE`` of the pixels. (Measured on the CPU:
payloads, abq frames and host windows equal, 0 values apart.) The rgb-mode
frames keep the port's f32 frame bound, 1 LSB on < 1e-3 of the pixels; the
window frames composed from them keep the GUI test's window bound, 2 LSB on
< 5e-3 (a flipped net byte moves its requantized ab, and the 4x cubic
upsample spreads it). The hint mirrors are equal after every click kind.
"""

import os
import sys

import numpy as np
import pytest
import torch

from ideepcolor_tpu import api as japi
from ideepcolor_tpu.api import colorize as jcolorize
from ideepcolor_tpu.engine import pipeline as jP
from ideepcolor_tpu_torch import api as tapi
from ideepcolor_tpu_torch.api import colorize as tcolorize
from ideepcolor_tpu_torch.engine import pipeline as tP
from ideepcolor_tpu_torch.models import caffe_net as tcaffe
from ideepcolor_tpu_torch.models import siggraph as tsig
from ideepcolor_tpu_torch.ops import host
from ideepcolor_tpu_torch.ops.hints import points_json_to_table
from ideepcolor_tpu_torch.ops.resize import cubic_resize_matrix_np

from _jax_host import use_jax_native
from _torch_caffe import jax_params_from_state_dict, smooth_image

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEACHER = os.path.join(ROOT, "weights", "teacher.npz")
XD = 64
WIN_HW = (96, 80)
FRAME_LSB, FRAME_SHARE = 1, 1e-3
WIN_LSB, WIN_SHARE = 2, 5e-3
PAYLOAD_SHARE = 5e-3


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    use_jax_native(mp, tmp_path_factory.mktemp("jax_hostops"))
    assert host.available()
    yield
    mp.undo()


@pytest.fixture(scope="module")
def seeded_pth(tmp_path_factory):
    """Seeded SIGGRAPH weights at width 0.125, as a .pth both loaders
    read."""
    path = tmp_path_factory.mktemp("seeded") / "w0125.pth"
    torch.save(tsig.init_state_dict(width=0.125, seed=9), path)
    return str(path)


def _hints(n, seed):
    rng = np.random.default_rng(seed)
    return [{"y": int(rng.integers(0, XD)), "x": int(rng.integers(0, XD)),
             "ab": rng.uniform(-90, 90, 2).tolist(),
             "radius": int(rng.integers(0, 4))} for _ in range(n)]


def _table(n, seed=0):
    return points_json_to_table(_hints(n, seed), XD)


def _pair(weights, jax_native, dist=False):
    """(JAX model, port model) on ``weights``, both with the same
    net-sized image."""
    img = smooth_image(5, XD, XD)
    jm = (japi.ColorizeImageJaxDist if dist else japi.ColorizeImageJax)(Xd=XD)
    jm.prep_net(path=weights)
    tm = (tapi.ColorizeImageTorchDist if dist
          else tapi.ColorizeImageTorch)(Xd=XD, device="cpu")
    tm.prep_net(path=weights)
    jm.set_image(img)
    tm.set_image(img)
    return jm, tm


def _lsb(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    d = d.max(-1) if d.ndim == 3 else d
    return int(d.max()), float(np.mean(d != 0))


def _agree(got, want, lsb, share):
    assert np.asarray(got).shape == np.asarray(want).shape
    m, s = _lsb(got, want)
    assert m <= lsb and s < share, (m, s)


def _mirrors_equal(tm, jm):
    np.testing.assert_array_equal(tm.input_ab, jm.input_ab)
    np.testing.assert_array_equal(tm.input_mask, jm.input_mask)
    np.testing.assert_array_equal(tm.input_ab_mc, jm.input_ab_mc)
    np.testing.assert_array_equal(tm.input_mask_mult, jm.input_mask_mult)


@pytest.mark.parametrize("values", [
    "ties", "edges", "random"])
def test_quantize_ab_u8_matches_jax(values):
    """quantize_ab_u8 against JAX's on values exactly half a step between
    two codes (rounded half to even), on and past the clip edges, and on
    seeded values."""
    step = 1.0 / tP.AB_Q_SCALE
    if values == "ties":
        k = np.arange(0, 255)
        ab = ((k + 0.5) * step - tP.AB_CLIP).astype(np.float32)
        ab = np.concatenate([ab, ab + np.float32(1e-5), ab - np.float32(1e-5)])
    elif values == "edges":
        ab = np.array([-1e9, -111, -110.5, -110, -109.9, 0, 109.9, 110,
                       110.4, 111, 1e9, -0.0], np.float32)
    else:
        ab = np.random.default_rng(3).uniform(-130, 130, 4096).astype(
            np.float32)
    ab = ab.reshape(-1, 2) if ab.size % 2 == 0 else ab[:-1].reshape(-1, 2)
    got = tP.quantize_ab_u8(torch.from_numpy(ab)).numpy()
    want = np.asarray(jP.quantize_ab_u8(ab))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert tP.AB_CLIP == jP.AB_CLIP and tP.AB_Q_SCALE == jP.AB_Q_SCALE


@pytest.mark.parametrize("weights", ["seeded", "teacher"])
@pytest.mark.parametrize("half", [False, True])
def test_abq_program_payload_matches_jax(weights, half, seeded_pth,
                                         jax_native):
    """make_table_click_abq_program against JAX's on the same image, table
    and weights: the payload's shape and type, equal but one step on at
    most PAYLOAD_SHARE of the values; the program's hint planes are the
    host rasterizer's."""
    path = TEACHER if weights == "teacher" else seeded_pth
    jm, tm = _pair(path, jax_native)
    for n, seed in ((0, 0), (5, 1), (12, 2)):
        boxes, values, count = _table(n, seed)
        jprog = jm._click_tbl_abq_half if half else jm._click_tbl_abq
        want = np.asarray(jprog(jm._dev_l_mc, jm.params, boxes, values,
                                np.int32(count)))
        tprog = tm._click_tbl_abq_half if half else tm._click_tbl_abq
        got, hints = tprog(tm._dev_l_mc, torch.from_numpy(boxes),
                           torch.from_numpy(values), count)
        got = got.numpy()
        side = XD // 2 if half else XD
        assert got.shape == want.shape == (side, side, 2)
        assert got.dtype == np.uint8
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and np.mean(d != 0) <= PAYLOAD_SHARE, \
            (d.max(), np.mean(d != 0))
        ab, mask = host.rasterize_hints(boxes, values, count, XD)
        np.testing.assert_array_equal(hints[:2].numpy(),
                                      ab.transpose(2, 0, 1))
        np.testing.assert_array_equal(hints[2:].numpy(),
                                      mask.transpose(2, 0, 1))


def test_compose_net_abq_host_and_window_equal_jax(jax_native):
    """The two host composes on the same payload, L plane and matrices
    give JAX's bytes: compose_net_abq_host (full and half) and
    compose_window_host."""
    rng = np.random.default_rng(4)
    l_net = rng.uniform(0, 100, (XD, XD)).astype(np.float32)
    for half in (False, True):
        side = XD // 2 if half else XD
        abq = rng.integers(0, 256, (side, side, 2)).astype(np.uint8)
        np.testing.assert_array_equal(
            tcolorize.compose_net_abq_host(l_net, abq, half=half),
            jcolorize.compose_net_abq_host(l_net, abq, half=half))
    rgb = rng.integers(0, 256, (XD, XD, 3)).astype(np.uint8)
    l_win = rng.uniform(0, 100, WIN_HW + (1,)).astype(np.float32)
    rh = cubic_resize_matrix_np(XD, WIN_HW[0])
    rw = cubic_resize_matrix_np(XD, WIN_HW[1])
    np.testing.assert_array_equal(
        tcolorize.compose_window_host(rgb, l_win, rh, rw),
        jcolorize.compose_window_host(rgb, l_win, rh, rw))


@pytest.mark.parametrize("half", [False, True])
def test_net_forward_table_abq_matches_jax(half, jax_native):
    """The abq click through the API: frames within 1 LSB on at most
    PAYLOAD_SHARE of the pixels, output_ab the requantized ab of the frame
    (equal to JAX's where the frames agree), the mirrors equal; the frame
    against the port's own rgb click within the same bound plus the
    payload's quantization; the lazy device ab that get_img_fullres reads
    is the host ab, uploaded on first read."""
    jm, tm = _pair(TEACHER, jax_native)
    for n, seed in ((0, 0), (6, 3), (12, 2)):
        table = _table(n, seed)
        want = jm.net_forward_table_abq(*table, half=half)
        got = tm.net_forward_table_abq(*table, half=half)
        assert isinstance(got, np.ndarray) and got.shape == (XD, XD, 3)
        _agree(got, want, 1, PAYLOAD_SHARE)
        _mirrors_equal(tm, jm)
        same = np.all(got == want, -1)
        assert np.abs(tm.output_ab - jm.output_ab).max(0)[same].max() <= 1e-4
        a, b = host.rgb2lab_u8_ab(got)
        np.testing.assert_array_equal(tm.output_ab, np.stack([a, b]))
        assert tm._dev_out_ab_val is None            # parked on the host
    full = tm.get_img_fullres()
    assert tm._dev_out_ab_val is not None             # uploaded on read
    np.testing.assert_array_equal(
        tm._dev_output_ab.numpy(), tm.output_ab.transpose(1, 2, 0))
    want_full = tP.fullres_fuse(tm._dev_l_fullres,
                                torch.from_numpy(np.ascontiguousarray(
                                    tm.output_ab.transpose(1, 2, 0))),
                                tm._dev_rh, tm._dev_rw).numpy()
    np.testing.assert_array_equal(full, want_full)
    _agree(full, jm.get_img_fullres(), 1, PAYLOAD_SHARE)
    # a later rgb click replaces the parked ab
    rgb = tm.net_forward_table(*_table(3, 7))
    assert tm._out_ab_host_pending is None
    np.testing.assert_array_equal(tm.get_img_fullres(), tP.fullres_fuse(
        tm._dev_l_fullres, tm._dev_output_ab, tm._dev_rh,
        tm._dev_rw).numpy())
    assert rgb.shape == (XD, XD, 3)


@pytest.mark.parametrize("mode", ["rgb", "abq", "abq_half"])
def test_net_forward_table_win_host_matches_jax(mode, jax_native,
                                                monkeypatch):
    """The host-window click in each IDEEPCOLOR_NET_CLICK mode against
    JAX's: the window frames within WIN_*, the mirrors equal; in rgb mode
    the window is compose_window_host of the port's own net frame, in the
    abq modes the requantized ab stays parked on the host."""
    monkeypatch.setenv("IDEEPCOLOR_NET_CLICK", mode)
    jm, tm = _pair(TEACHER, jax_native)
    img = smooth_image(8, *WIN_HW)
    l_win = host.rgb2lab(img.astype(np.float32) / 255.0)[..., :1]
    rh = cubic_resize_matrix_np(XD, WIN_HW[0])
    rw = cubic_resize_matrix_np(XD, WIN_HW[1])
    for n, seed in ((0, 0), (6, 3)):
        table = _table(n, seed)
        want = jm.net_forward_table_win_host(*table, l_win, rh, rw)
        got = tm.net_forward_table_win_host(*table, l_win, rh, rw)
        assert got.shape == WIN_HW + (3,) and got.dtype == np.uint8
        _agree(got, want, WIN_LSB, WIN_SHARE)
        _mirrors_equal(tm, jm)
        if mode == "rgb":
            np.testing.assert_array_equal(
                got, tcolorize.compose_window_host(tm.output_rgb, l_win,
                                                   rh, rw))
        else:
            assert tm._out_ab_host_pending is not None


def test_suggest_host_matches_jax_and_the_device_window(jax_native):
    """net_forward_table_suggest_host: the window composed on the host from
    the net frame equals compose_window_host of it, agrees with JAX's
    within WIN_*, and with the port's device window click on the same
    table within the frame bound; the palette's row 0 is the previous
    frame's pixel, exactly; the mirrors equal JAX's."""
    jm, tm = _pair(TEACHER, jax_native)
    jd, td = _pair(TEACHER, jax_native, dist=True)
    empty = _table(0)
    jd.predict_dist_table(*empty)
    td.predict_dist_table(*empty)
    jm.net_forward_table(*empty)
    tm.net_forward_table(*empty)
    img = smooth_image(8, *WIN_HW)
    l_win = host.rgb2lab(img.astype(np.float32) / 255.0)[..., :1]
    rh = cubic_resize_matrix_np(XD, WIN_HW[0])
    rw = cubic_resize_matrix_np(XD, WIN_HW[1])
    for n, (h, w) in ((3, (10, 20)), (7, (40, 33))):
        prev = tm.output_rgb.copy()
        table = _table(n, n)
        want_win, want_colors = jm.net_forward_table_suggest_host(
            *table, l_win, rh, rw, jd, h, w, K=9)
        got_win, got_colors = tm.net_forward_table_suggest_host(
            *table, l_win, rh, rw, td, h, w, K=9)
        assert got_win.shape == WIN_HW + (3,)
        assert got_colors.shape == (10, 3) and got_colors.dtype == np.float32
        np.testing.assert_array_equal(
            got_colors[0], prev[h, w].astype(np.float32) / 255.0)
        np.testing.assert_array_equal(got_colors[0], want_colors[0])
        assert np.all((got_colors >= 0) & (got_colors <= 1))
        np.testing.assert_array_equal(
            got_win, tcolorize.compose_window_host(tm.output_rgb, l_win,
                                                   rh, rw))
        _agree(got_win, want_win, WIN_LSB, WIN_SHARE)
        _agree(tm.output_rgb, jm.output_rgb, FRAME_LSB, FRAME_SHARE)
        _mirrors_equal(tm, jm)
        assert tm._dev_output_rgb is not None         # kept for row 0
        device_win = tm.net_forward_table_win(*table, l_win, rh, rw)
        _agree(got_win, device_win, FRAME_LSB, 1e-2)


def test_packed_suggest_program(jax_native):
    """make_table_click_suggest_program: the frame rows and out_ab equal the
    table click's on the same table; palette row 0 the previous frame's
    pixel exactly; the suggestion rows within 1/255 of the port's own
    net_forward_table_win_suggest colors drawn from the same generator
    state; the rest of the row zero."""
    _, tm = _pair(TEACHER, jax_native)
    _, td = _pair(TEACHER, jax_native, dist=True)
    td.predict_dist_table(*_table(0))
    prev = tm.net_forward_table(*_table(2, 4)).copy()
    boxes, values, count = (torch.from_numpy(np.asarray(a))
                            if not isinstance(a, int) else a
                            for a in _table(5, 6))
    K, h, w = 9, 30, 17
    state = td._generator.get_state()
    packed, out_ab, hints = tm._click_tbl_suggest(
        tm._dev_l_net, tm._dev_l_mc, boxes, values, count, td._dev_dist, h,
        w, td._dev_pts(), torch.from_numpy(prev), td._generator, K=K,
        map_div=td.dist_map_div)
    rgb, want_ab, _ = tm._click_tbl(tm._dev_l_net, tm._dev_l_mc, boxes,
                                    values, count)
    packed = packed.numpy()
    assert packed.shape == (XD + 1, XD, 3) and packed.dtype == np.uint8
    np.testing.assert_array_equal(packed[:XD], rgb.numpy())
    np.testing.assert_array_equal(out_ab.numpy(), want_ab.numpy())
    np.testing.assert_array_equal(packed[XD, 0], prev[h, w])
    assert not packed[XD, K + 1:].any()
    td._generator.set_state(state)
    l_win = np.full((16, 16, 1), 50.0, np.float32)
    m = cubic_resize_matrix_np(XD, 16)
    _, colors = tm.net_forward_table_win_suggest(
        *_table(5, 6), l_win, m, m, td, h, w, K=K)
    d = np.abs(packed[XD, 1:K + 1] / 255.0 - colors[1:])
    assert d.max() <= 1 / 255 + 1e-6


@pytest.mark.parametrize("kind", ["table", "win", "win_suggest",
                                  "suggest_host", "win_host", "abq",
                                  "predict", "suggest_table"])
def test_hint_mirrors_equal_jax_after_each_click(kind, jax_native):
    """After every click kind the numpy hint mirrors (input_ab, input_mask
    and the normalized forms) equal the JAX API's: both rasterize the
    click's table on the host."""
    dist = kind in ("predict", "suggest_table")
    jm, tm = _pair(TEACHER, jax_native, dist=dist)
    jd = td = None
    if kind in ("win_suggest", "suggest_host"):
        jd, td = _pair(TEACHER, jax_native, dist=True)
        jd.predict_dist_table(*_table(0))
        td.predict_dist_table(*_table(0))
        jm.net_forward_table(*_table(0))
        tm.net_forward_table(*_table(0))
    l_win = np.full(WIN_HW + (1,), 60.0, np.float32)
    rh = cubic_resize_matrix_np(XD, WIN_HW[0])
    rw = cubic_resize_matrix_np(XD, WIN_HW[1])
    table = _table(15, 21)
    for m, d in ((jm, jd), (tm, td)):
        out = {"table": lambda: m.net_forward_table(*table),
               "win": lambda: m.net_forward_table_win(*table, l_win, rh, rw),
               "win_suggest": lambda: m.net_forward_table_win_suggest(
                   *table, l_win, rh, rw, d, 5, 6),
               "suggest_host": lambda: m.net_forward_table_suggest_host(
                   *table, l_win, rh, rw, d, 5, 6),
               "win_host": lambda: m.net_forward_table_win_host(
                   *table, l_win, rh, rw),
               "abq": lambda: m.net_forward_table_abq(*table),
               "predict": lambda: m.predict_dist_table(*table),
               "suggest_table": lambda: m.suggest_table(*table, 5, 6)}[kind]()
        assert not (np.isscalar(out) and out == -1)
    _mirrors_equal(tm, jm)
    assert tm.input_mask.sum() > 0


def test_sentinels(jax_native):
    """-1 where JAX returns -1: no image, no net, no dist map, no previous
    frame, a backend without the program."""
    l_win = np.full(WIN_HW + (1,), 60.0, np.float32)
    rh = cubic_resize_matrix_np(XD, WIN_HW[0])
    rw = cubic_resize_matrix_np(XD, WIN_HW[1])
    table = _table(2)
    for cls in (japi.ColorizeImageJax, tapi.ColorizeImageTorch):
        kw = {} if cls is japi.ColorizeImageJax else {"device": "cpu"}
        m = cls(Xd=XD, **kw)
        assert m.net_forward_table_abq(*table) == -1          # no image
        assert m.net_forward_table_win_host(*table, l_win, rh, rw) == -1
        m.set_image(smooth_image(5, XD, XD))
        assert m.net_forward_table_abq(*table, half=True) == -1   # no net
        assert m.net_forward_table_suggest_host(
            *table, l_win, rh, rw, None, 0, 0) == -1
        m.prep_net(path=TEACHER)
        d = (japi.ColorizeImageJaxDist if cls is japi.ColorizeImageJax
             else tapi.ColorizeImageTorchDist)(Xd=XD, **kw)
        d.prep_net(path=TEACHER)
        d.set_image(smooth_image(5, XD, XD))
        # no dist map yet, then no previous frame
        assert m.net_forward_table_suggest_host(
            *table, l_win, rh, rw, d, 0, 0) == -1
        d.predict_dist_table(*table)
        assert m.net_forward_table_suggest_host(
            *table, l_win, rh, rw, d, 0, 0) == -1
        # a dist-headed model has no table programs
        assert d.net_forward_table_abq(*table) == -1
        assert d.net_forward_table_win_host(*table, l_win, rh, rw) == -1


@pytest.mark.parametrize("value", [None, "rgb", "abq", "abq_half", "ABQ",
                                   "abq-half", ""])
def test_net_click_mode_parsing(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("IDEEPCOLOR_NET_CLICK", raising=False)
    else:
        monkeypatch.setenv("IDEEPCOLOR_NET_CLICK", value)
    assert tcolorize.net_click_mode() == jcolorize.net_click_mode()


@pytest.fixture(scope="module")
def caffe_main(tmp_path_factory):
    root = tmp_path_factory.mktemp("caffe_main")
    sd = tcaffe.init_state_dict("main", seed=12, calibrate=True)
    npz = str(root / "main.npz")
    np.savez(npz, **jax_params_from_state_dict(sd, "main"))
    return npz


@pytest.mark.parametrize("half", [False, True])
def test_caffe_main_abq_clicks_match_jax(half, caffe_main, jax_native):
    """The Caffe main class's abq clicks (``_click_tbl_abq`` and
    ``_click_tbl_abq_half`` in ``_make_click``) against JAX's on seeded
    calibrated weights: payload-composed frames within 1 LSB on the
    Caffe family's 5e-2 share (its seeded nets carry last-bit conv
    differences to ab at a few 1e-3), the mirrors equal."""
    img = smooth_image(5, XD, XD)
    jm = japi.ColorizeImageJaxCaffe(Xd=XD)
    jm.prep_net(caffemodel_path=caffe_main)
    tm = tapi.ColorizeImageTorchCaffe(Xd=XD, device="cpu")
    tm.prep_net(caffemodel_path=caffe_main)
    jm.set_image(img)
    tm.set_image(img)
    assert tm._click_tbl_suggest is not None
    for n, seed in ((0, 0), (8, 5)):
        table = _table(n, seed)
        want = jm.net_forward_table_abq(*table, half=half)
        got = tm.net_forward_table_abq(*table, half=half)
        _agree(got, want, 1, 5e-2)
        _mirrors_equal(tm, jm)


def test_interactive_latest_mirrors_match_jax(jax_native):
    """InteractiveSession.latest rasterizes the mirrors on the host from
    the submitted table: equal to the JAX session's."""
    from ideepcolor_tpu.engine.interactive import \
        InteractiveSession as JSession
    from ideepcolor_tpu_torch.engine.interactive import InteractiveSession
    jm, tm = _pair(TEACHER, jax_native)
    js, ts = JSession(jm), InteractiveSession(tm)
    for n in (3, 9, 14):
        table = _table(n, n)
        js.submit(*table)
        ts.submit(*table)
    _, jframe = js.latest()
    _, tframe = ts.latest()
    _agree(tframe, jframe, FRAME_LSB, FRAME_SHARE)
    _mirrors_equal(tm, jm)
    ab, mask = host.rasterize_hints(*_table(14, 14), XD)
    np.testing.assert_array_equal(tm.input_ab, ab.transpose(2, 0, 1))


def test_train_loader_lab_matches_jax(tmp_path, jax_native):
    """The folder loader's batches convert to Lab with the native host
    runtime on both sides: L and ab equal JAX's loader's (same crops from
    one seed; the decoders agree on PNG)."""
    from ideepcolor_tpu.train import data as jdata
    from ideepcolor_tpu_torch.train import data as tdata
    from ideepcolor_tpu_torch.utils.imageio import encode_png
    for i in range(3):
        with open(tmp_path / f"im{i}.png", "wb") as f:
            f.write(encode_png(smooth_image(30 + i, 70 + 9 * i, 90)))
    jl = jdata.ImageFolderLoader(str(tmp_path), batch_size=4, size=48,
                                 seed=3, workers=1, prefetch=1)
    tl = tdata.ImageFolderLoader(str(tmp_path), batch_size=4, size=48,
                                 seed=3, workers=1, prefetch=1)
    try:
        jb, tb = next(jl), next(tl)
    finally:
        jl.close()
        tl.close()
    np.testing.assert_array_equal(tb["l"].numpy().transpose(0, 2, 3, 1),
                                  np.asarray(jb["l"]))
    np.testing.assert_array_equal(tb["ab"].numpy().transpose(0, 2, 3, 1),
                                  np.asarray(jb["ab"]))


def test_server_abq_session_click(monkeypatch, jax_native):
    """A port server (device "cpu") under IDEEPCOLOR_NET_CLICK=abq: a
    session click is the abq click of the session's model (the frame equal
    to net_forward_table_abq on the same table), a full-res session click
    stays rgb (equal to the rgb click's full-res frame), and warmup
    captures nothing on the CPU."""
    from ideepcolor_tpu_torch.apps import serve
    from ideepcolor_tpu_torch.utils.imageio import decode_image, encode_png
    monkeypatch.setenv("IDEEPCOLOR_NET_CLICK", "abq")
    svc = serve.ColorizeService(size=XD, weights=TEACHER, device="cpu",
                                dtype="float32")
    svc.warmup()
    img = smooth_image(6, 80, 70)
    sid = svc.session_open(encode_png(img))["id"]
    hints = _hints(4, 2)
    got = decode_image(svc.session_click(sid, hints))
    ref = tapi.ColorizeImageTorch(Xd=XD, device="cpu")
    ref.prep_net(path=TEACHER)
    ref.load_image_array(img)
    table = points_json_to_table(hints, XD)
    np.testing.assert_array_equal(got, ref.net_forward_table_abq(*table))
    full = decode_image(svc.session_click(sid, hints, fullres=True))
    ref.net_forward_table(*table)
    np.testing.assert_array_equal(full, ref.get_img_fullres())
    svc.session_close(sid)
