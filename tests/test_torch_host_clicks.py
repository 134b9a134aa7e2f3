"""The port's table clicks, whose every frame is composed on the device,
against the JAX package's clicks and host composes, on the CPU at Xd=64,
on the same numpy-seeded inputs: the window and click+suggest clicks
against JAX's host-composed ``net_forward_table_win_host`` (its ``rgb``
mode) and ``net_forward_table_suggest_host``, the host-rasterized hint
mirrors and the full-res getters after every click kind, the -1
sentinels, the server's session click under the retired
``IDEEPCOLOR_NET_CLICK`` and the loader's host Lab.

JAX's host runtime is native here (its library built from its own source
into a temporary directory, ``_jax_host.py``), so its host composes run
the arithmetic they run in the JAX GUI and server.

Bounds. Net frames keep the port's f32 frame bound, 1 LSB on < 1e-3 of
the pixels. A frame upsampled from the requantized ab (the window frames,
the full-res frame) keeps the GUI test's window bound, 2 LSB on < 5e-3: a
flipped net byte moves its requantized ab, and the cubic or bilinear
upsample spreads it. The Caffe family's seeded nets carry last-bit conv
differences to ab at a few 1e-3, so their frames keep a share of 5e-2.
The hint mirrors are equal after every click kind.
"""

import os

import numpy as np
import pytest
import torch

from ideepcolor_tpu import api as japi
from ideepcolor_tpu.engine.interactive import InteractiveSession as JSession
from ideepcolor_tpu_torch import api as tapi
from ideepcolor_tpu_torch.engine.interactive import InteractiveSession
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
CAFFE_SHARE = 5e-2


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


def _win_args(H, W, seed=8):
    """A window's (H, W, 1) L plane from a seeded image and the GUI's cubic
    matrices from the net size to it, all host arrays."""
    l_win = host.rgb2lab(smooth_image(seed, H, W).astype(np.float32)
                         / 255.0)[..., :1]
    return (l_win, cubic_resize_matrix_np(XD, H),
            cubic_resize_matrix_np(XD, W))


def _dist_pair(weights, jax_native, jm, tm):
    """The dist models beside (jm, tm), on their image, after a first
    table click on both, so the click+suggest click has a map and a
    previous frame."""
    jd, td = _pair(weights, jax_native, dist=True)
    for m, d in ((jm, jd), (tm, td)):
        d.predict_dist_table(*_table(0))
        m.net_forward_table(*_table(0))
    return jd, td


def _dense_planes(table):
    """A table's hints as the dense (2,Xd,Xd) ab and (1,Xd,Xd) mask
    planes of the reference contract."""
    ab, mask = host.rasterize_hints(*table, XD)
    return ab.transpose(2, 0, 1), mask.transpose(2, 0, 1)


def _click(kind, m, d, table, win):
    """One click of ``kind`` on model ``m`` (dist model ``d``), the same
    call on either package; returns what the click returns."""
    if kind == "interactive":
        sess = (JSession if isinstance(m, japi.ColorizeImageJax)
                else InteractiveSession)(m)
        sess.submit(*table, win)
        return sess.latest()[1]
    return {"table": lambda: m.net_forward_table(*table),
            "win": lambda: m.net_forward_table_win(*table, *win),
            "win_suggest": lambda: m.net_forward_table_win_suggest(
                *table, *win, d, 5, 6),
            "predict": lambda: m.predict_dist_table(*table),
            "suggest_table": lambda: m.suggest_table(*table, 5, 6),
            "dense": lambda: m.net_forward(*_dense_planes(table)),
            "fullres": lambda: m.net_forward_fullres(*_dense_planes(table)),
            }[kind]()


@pytest.mark.parametrize("kind", ["table", "win", "win_suggest", "predict",
                                  "suggest_table", "dense", "fullres",
                                  "interactive"])
def test_hint_mirrors_equal_jax_after_each_click(kind, jax_native):
    """After every click kind the numpy hint mirrors (input_ab, input_mask
    and the normalized forms) equal the JAX API's: the table clicks
    rasterize the click's table on the host, the dense clicks take the
    planes as given, and an InteractiveSession submit with window
    arguments rasterizes its table when its frame is fetched."""
    dist = kind in ("predict", "suggest_table")
    jm, tm = _pair(TEACHER, jax_native, dist=dist)
    jd = td = None
    if kind == "win_suggest":
        jd, td = _dist_pair(TEACHER, jax_native, jm, tm)
    l_win = np.full(WIN_HW + (1,), 60.0, np.float32)
    win = (l_win, cubic_resize_matrix_np(XD, WIN_HW[0]),
           cubic_resize_matrix_np(XD, WIN_HW[1]))
    table = _table(15, 21)
    for m, d in ((jm, jd), (tm, td)):
        out = _click(kind, m, d, table, win)
        assert not (np.isscalar(out) and out == -1)
    _mirrors_equal(tm, jm)
    assert tm.input_mask.sum() > 0


def test_interactive_latest_mirrors_match_jax(jax_native):
    """InteractiveSession.latest rasterizes the mirrors on the host from
    the submitted table: equal to the JAX session's."""
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


@pytest.mark.parametrize("win_hw", [(512, 384), (384, 512), (256, 256)])
@pytest.mark.parametrize("weights", ["seeded", "teacher"])
def test_device_window_matches_jax_host_compose(weights, win_hw, seeded_pth,
                                                jax_native, monkeypatch):
    """net_forward_table_win, the window composed on the device, against
    JAX's net_forward_table_win_host in its rgb mode, the reference's own
    host compose of the net frame (ref ui/gui_draw.py:280-284): the window
    frames within WIN_*, the net frames within the frame bound, the
    mirrors equal."""
    monkeypatch.delenv("IDEEPCOLOR_NET_CLICK", raising=False)
    path = TEACHER if weights == "teacher" else seeded_pth
    jm, tm = _pair(path, jax_native)
    win = _win_args(*win_hw)
    for n, seed in ((0, 0), (6, 3), (12, 2)):
        table = _table(n, seed)
        want = jm.net_forward_table_win_host(*table, *win)
        got = tm.net_forward_table_win(*table, *win)
        assert got.shape == win_hw + (3,) and got.dtype == np.uint8
        _agree(got, want, WIN_LSB, WIN_SHARE)
        _agree(tm.output_rgb, jm.output_rgb, FRAME_LSB, FRAME_SHARE)
        _mirrors_equal(tm, jm)


def _one_hot_map(seed):
    """A (Xd/4, Xd/4, 529) distribution map with all of each cell's mass
    on one seeded bin: every sample of the suggestion chain lands there,
    whatever the random numbers, so its palette is deterministic."""
    rng = np.random.default_rng(seed)
    side = XD // 4
    dist = np.zeros((side, side, 529), np.float32)
    dist[np.arange(side)[:, None], np.arange(side)[None, :],
         rng.integers(0, 529, (side, side))] = 1.0
    return dist


@pytest.mark.parametrize("K", [5, 9])
@pytest.mark.parametrize("weights", ["seeded", "teacher"])
def test_device_suggest_window_matches_jax_suggest_host(
        weights, K, seeded_pth, jax_native):
    """net_forward_table_win_suggest against JAX's
    net_forward_table_suggest_host (one program for the frame and the
    packed palette row, the window composed on the host): the windows
    within WIN_*, palette row 0 the port's previous frame's pixel exactly
    and JAX's row 0, the K suggestions within one step of 1/255 of JAX's
    packed rows (a one-hot map makes them independent of the two
    packages' random numbers), the mirrors equal."""
    import jax.numpy as jnp
    path = TEACHER if weights == "teacher" else seeded_pth
    jm, tm = _pair(path, jax_native)
    jd, td = _dist_pair(path, jax_native, jm, tm)
    dist = _one_hot_map(K)
    jd._dev_dist = jnp.asarray(dist)
    td._dev_dist = torch.from_numpy(dist)
    win = _win_args(96, 80)
    for n, (h, w) in ((3, (10, 20)), (7, (40, 33))):
        prev = tm.output_rgb.copy()
        table = _table(n, n)
        want_win, want_colors = jm.net_forward_table_suggest_host(
            *table, *win, jd, h, w, K=K)
        got_win, got_colors = tm.net_forward_table_win_suggest(
            *table, *win, td, h, w, K=K)
        assert got_win.shape == (96, 80, 3)
        assert got_colors.shape == want_colors.shape == (K + 1, 3)
        assert got_colors.dtype == np.float32
        np.testing.assert_array_equal(
            got_colors[0], prev[h, w].astype(np.float32) / 255.0)
        np.testing.assert_array_equal(got_colors[0], want_colors[0])
        assert np.abs(got_colors[1:] - want_colors[1:]).max() \
            <= 1 / 255 + 1e-6
        _agree(got_win, want_win, WIN_LSB, WIN_SHARE)
        _agree(tm.output_rgb, jm.output_rgb, FRAME_LSB, FRAME_SHARE)
        _mirrors_equal(tm, jm)


@pytest.fixture(scope="module")
def caffe_main(tmp_path_factory):
    root = tmp_path_factory.mktemp("caffe_main")
    sd = tcaffe.init_state_dict("main", seed=12, calibrate=True)
    npz = str(root / "main.npz")
    np.savez(npz, **jax_params_from_state_dict(sd, "main"))
    return npz


def _caffe_pair(caffe_main, image=True):
    jm = japi.ColorizeImageJaxCaffe(Xd=XD)
    tm = tapi.ColorizeImageTorchCaffe(Xd=XD, device="cpu")
    jm.prep_net(caffemodel_path=caffe_main)
    tm.prep_net(caffemodel_path=caffe_main)
    if image:
        img = smooth_image(5, XD, XD)
        jm.set_image(img)
        tm.set_image(img)
    return jm, tm


# (backend, entry, missing state); the SIGGRAPH click+suggest click, and
# its window click without an image, are held in test_torch_dist_api.py
@pytest.mark.parametrize("backend,entry,missing", [
    ("siggraph", "table", "image"), ("siggraph", "table", "net"),
    ("siggraph", "win", "net"),
    ("caffe", "table", "image"), ("caffe", "table", "net"),
    ("caffe", "win", "image"), ("caffe", "win", "net")])
def test_sentinels(backend, entry, missing, caffe_main):
    """-1 where JAX returns -1, from the table entries that remain: a model
    without an image, or with an image and no net."""
    win = (np.full(WIN_HW + (1,), 60.0, np.float32),
           cubic_resize_matrix_np(XD, WIN_HW[0]),
           cubic_resize_matrix_np(XD, WIN_HW[1]))
    table = _table(2)
    if backend == "siggraph":
        models = (japi.ColorizeImageJax(Xd=XD),
                  tapi.ColorizeImageTorch(Xd=XD, device="cpu"))
    else:
        models = (japi.ColorizeImageJaxCaffe(Xd=XD),
                  tapi.ColorizeImageTorchCaffe(Xd=XD, device="cpu"))
    for m in models:
        if missing == "image":
            if backend == "siggraph":
                m.prep_net(path=TEACHER)
            else:
                m.prep_net(caffemodel_path=caffe_main)
        else:
            m.set_image(smooth_image(5, XD, XD))
        out = (m.net_forward_table(*table) if entry == "table"
               else m.net_forward_table_win(*table, *win))
        assert isinstance(out, int) and out == -1


@pytest.mark.parametrize("kind", ["table", "win", "win_suggest",
                                  "interactive"])
def test_fullres_getters_after_each_click(kind, jax_native):
    """After each table click kind on a 150x97 image, get_img_fullres (the
    requantized ab upsampled onto the full-res L) within WIN_*,
    get_img_mask_fullres equal, and output_ab within 1e-4 of JAX's
    wherever the net frames agree."""
    jm, tm = _pair(TEACHER, jax_native)
    img = smooth_image(6, 150, 97)
    jm.load_image_array(img)
    tm.load_image_array(img)
    jd = td = None
    if kind == "win_suggest":
        jd, td = _dist_pair(TEACHER, jax_native, jm, tm)
        jd.load_image_array(img)
        td.load_image_array(img)
        for d in (jd, td):
            d.predict_dist_table(*_table(0))
    win = _win_args(96, 80)
    for n, seed in ((0, 0), (9, 4)):
        table = _table(n, seed)
        for m, d in ((jm, jd), (tm, td)):
            out = _click(kind, m, d, table, win)
            assert not (np.isscalar(out) and out == -1)
        full = tm.get_img_fullres()
        assert full.shape == (150, 97, 3) and full.dtype == np.uint8
        _agree(full, jm.get_img_fullres(), WIN_LSB, WIN_SHARE)
        np.testing.assert_array_equal(tm.get_img_mask_fullres(),
                                      jm.get_img_mask_fullres())
        same = np.all(tm.output_rgb == jm.output_rgb, -1)
        assert tm.output_ab.shape == (2, XD, XD)
        assert np.abs(tm.output_ab - jm.output_ab).max(0)[same].max() <= 1e-4
        _agree(tm.output_rgb, jm.output_rgb, FRAME_LSB, FRAME_SHARE)


@pytest.mark.parametrize("seed", [0, 1])
def test_caffe_main_window_click_matches_jax_host_compose(
        seed, caffe_main, jax_native, monkeypatch):
    """The Caffe main class's window click (``_click_tbl_win`` in
    ``_make_click``) against JAX's net_forward_table_win_host in its rgb
    mode on seeded calibrated weights: the windows within WIN_LSB on the
    Caffe family's share, the net frames within 1 LSB on it, the mirrors
    equal."""
    monkeypatch.delenv("IDEEPCOLOR_NET_CLICK", raising=False)
    jm, tm = _caffe_pair(caffe_main)
    win = _win_args(160, 128, seed=seed)
    for n in (0, 8):
        table = _table(n, seed)
        want = jm.net_forward_table_win_host(*table, *win)
        got = tm.net_forward_table_win(*table, *win)
        assert got.shape == (160, 128, 3)
        _agree(got, want, WIN_LSB, CAFFE_SHARE)
        _agree(tm.output_rgb, jm.output_rgb, FRAME_LSB, CAFFE_SHARE)
        _mirrors_equal(tm, jm)


@pytest.mark.parametrize("value", ["abq", "abq_half"])
def test_server_session_click_ignores_retired_net_click(value, monkeypatch):
    """A port server (device "cpu") with IDEEPCOLOR_NET_CLICK set to a
    value the JAX server reads: warmup runs, and the session click's reply,
    net-size and full-res, is byte-equal to the reply without the variable
    and decodes to the table click's frame on the same table."""
    from ideepcolor_tpu_torch.apps import serve
    from ideepcolor_tpu_torch.utils.imageio import decode_image, encode_png
    monkeypatch.setenv("IDEEPCOLOR_NET_CLICK", value)
    svc = serve.ColorizeService(size=XD, weights=TEACHER, device="cpu",
                                dtype="float32")
    svc.warmup()
    img = smooth_image(6, 80, 70)
    sid = svc.session_open(encode_png(img))["id"]
    hints = _hints(4, 2)
    got = svc.session_click(sid, hints)
    got_full = svc.session_click(sid, hints, fullres=True)
    monkeypatch.delenv("IDEEPCOLOR_NET_CLICK")
    assert svc.session_click(sid, hints) == got
    assert svc.session_click(sid, hints, fullres=True) == got_full
    svc.session_close(sid)
    ref = tapi.ColorizeImageTorch(Xd=XD, device="cpu")
    ref.prep_net(path=TEACHER)
    ref.load_image_array(img)
    np.testing.assert_array_equal(
        decode_image(got),
        ref.net_forward_table(*points_json_to_table(hints, XD)))
