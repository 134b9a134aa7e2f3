"""The port's dist backend and the GUI's window and click+suggest paths
against the JAX API, on the CPU: ColorizeImageJaxDist and
ColorizeImageTorchDist(device="cpu") at Xd=64 on the bundled width-0.25
student. The deterministic part (distribution map, entropy, frames) is held
to JAX; the suggestions, whose random numbers differ, by their contract."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ideepcolor_tpu import api as japi
from ideepcolor_tpu.api import colorize as jcolorize
from ideepcolor_tpu.engine import pipeline as jP
from ideepcolor_tpu.ops import resize as jresize
from ideepcolor_tpu_torch.api import (ColorizeImageTorch,
                                      ColorizeImageTorchDist)
from ideepcolor_tpu_torch.api import colorize as tcolorize
from ideepcolor_tpu_torch.ops import colorspace as tcs
from ideepcolor_tpu_torch.ops.hints import points_json_to_table
from ideepcolor_tpu_torch.ops.resize import cubic_resize_matrix_np

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(ROOT, "weights", "student_w025.npz")
XD = 64
WIN_HW = (96, 80)
MAP_BOUND = 1e-5


def _image(seed, H, W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * yy + c) * np.cos(5 * xx - 2 * c)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 12, (H, W, 3)),
                   0, 255).astype(np.uint8)


def _table(n, seed=1):
    rng = np.random.default_rng(seed)
    return points_json_to_table(
        [{"y": int(rng.integers(0, XD)), "x": int(rng.integers(0, XD)),
          "ab": rng.uniform(-80, 80, 2).tolist(),
          "radius": int(rng.integers(0, 4))} for _ in range(n)], XD)


def _torch_pair():
    m = ColorizeImageTorch(Xd=XD, device="cpu")
    m.prep_net(path=STUDENT)
    d = ColorizeImageTorchDist(Xd=XD, device="cpu")
    d.prep_net(path=STUDENT)
    return m, d


@pytest.fixture(scope="module")
def jax_pair():
    m = japi.ColorizeImageJax(Xd=XD)
    m.prep_net(path=STUDENT)
    d = japi.ColorizeImageJaxDist(Xd=XD)
    d.prep_net(path=STUDENT)
    return m, d


def _window(im_net):
    """The GUI's window inputs for a 96x80 window: the window image's L and
    the cubic matrices, at the exact size for the port and padded to JAX's
    128 bucket for the JAX method."""
    H, W = WIN_HW
    win_rgb = _image(21, H, W)
    pad = np.zeros((128, 128, 3), np.uint8)
    pad[:H, :W] = win_rgb
    l_pad = jP.rgb_to_lab_dev_u8(jnp.asarray(pad))[..., :1]
    jax_args = (l_pad, jnp.asarray(jresize.cubic_resize_matrix_np(XD, H, 128)),
                jnp.asarray(jresize.cubic_resize_matrix_np(XD, W, 128)))
    l_win = tcs.rgb_to_lab(torch.from_numpy(win_rgb).float() / 255.0)[..., :1]
    port_args = (l_win.contiguous(), cubic_resize_matrix_np(XD, H),
                 cubic_resize_matrix_np(XD, W))
    return jax_args, port_args


def _lsb(got, want):
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    return int(d.max()), float(np.mean(d != 0))


@pytest.mark.parametrize("n_hints", [0, 5])
def test_predict_dist_table_matches_jax(jax_pair, n_hints):
    """The distribution map after predict_dist_table: dist_ab (529,64,64),
    the x4 repeat of the (16,16,529) device map, within 1e-5 of JAX's
    (measured 2.0e-8); dist_ab_grid (23,23,64,64); compute_entropy within
    1e-4 (measured 7.2e-6); the hint mirrors equal JAX's exactly."""
    _, jd = jax_pair
    _, td = _torch_pair()
    im = _image(4, XD, XD)
    for d in (jd, td):
        d.set_image(im)
        assert d.predict_dist_table(*_table(n_hints)) == 0
        assert d.dist_ab_set
        d.compute_entropy()
    assert tuple(td._dev_dist.shape) == (16, 16, 529)
    assert td.dist_ab.shape == jd.dist_ab.shape == (529, XD, XD)
    assert np.abs(td.dist_ab - jd.dist_ab).max() <= MAP_BOUND
    assert np.abs(td.dist_ab.sum(0) - 1).max() <= 1e-5
    assert np.array_equal(td.dist_ab[:, 4:8, 8:12],
                          np.broadcast_to(td.dist_ab[:, 4:5, 8:9],
                                          (529, 4, 4)))
    assert td.dist_ab_full is td.dist_ab
    assert td.dist_ab_grid.shape == (23, 23, XD, XD)
    assert td.dist_entropy.shape == (XD, XD)
    assert np.abs(td.dist_entropy - jd.dist_entropy).max() <= 1e-4
    assert np.array_equal(td.input_ab, jd.input_ab)
    assert np.array_equal(td.input_mask, jd.input_mask)
    assert (td.input_mask.sum() > 0) == (n_hints > 0)


def test_dense_dist_forward_matches_jax(jax_pair):
    """Dense net_forward of the dist backend returns the double-110
    regression as (2,Xd,Xd) numpy, within 0.11 of JAX's (110 x the U-Net's
    1e-3; measured 9.5e-3), composes no frame, and sets the same map as
    the table path for the same hints; the lazy dist_ab is invalidated."""
    _, jd = jax_pair
    _, td = _torch_pair()
    im = _image(5, XD, XD)
    table = _table(4, seed=2)
    outs = []
    for d in (jd, td):
        d.set_image(im)
        d.predict_dist_table(*table)
        first = d.dist_ab
        ab, mask = d.input_ab.copy(), d.input_mask.copy()
        outs.append(d.net_forward(ab * 0.5, mask))
        assert d.dist_ab is not first
        assert not np.array_equal(d.dist_ab, first)
    want, got = outs
    assert got.shape == want.shape == (2, XD, XD)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 0.11
    assert np.abs(got).max() > 110                    # scaled twice
    assert np.abs(td.dist_ab - jd.dist_ab).max() <= MAP_BOUND
    assert td.output_rgb is None
    # the table path and the dense path on the same hints: the same map
    td.predict_dist_table(*table)
    by_table = td.dist_ab
    td.net_forward(td.input_ab.copy(), td.input_mask.copy())
    assert np.array_equal(td.dist_ab, by_table)


def test_plain_backend_in_dist_mode_like_jax():
    """ColorizeImageTorch.prep_net(dist=True): net_forward returns the
    regression array and keeps the map; the model has no table programs."""
    m = ColorizeImageTorch(Xd=XD, device="cpu")
    m.prep_net(path=STUDENT, dist=True)
    m.set_image(_image(6, XD, XD))
    out = m.net_forward(np.zeros((2, XD, XD)), np.zeros((1, XD, XD)))
    assert out.shape == (2, XD, XD) and m.output_rgb is None
    assert tuple(m._dev_dist.shape) == (16, 16, 529)
    assert m.net_forward_table(*_table(1)) == -1
    assert m.net_forward_table_win(*_table(1), None, None, None) == -1


def test_get_ab_reccs_before_a_prediction_returns_0(capsys):
    for d in (japi.ColorizeImageJaxDist(Xd=XD),
              ColorizeImageTorchDist(Xd=XD, device="cpu")):
        assert d.get_ab_reccs(h=3, w=4) == 0
        assert "Need to set prediction first" in capsys.readouterr().out


def test_sentinels_match_jax(jax_pair):
    """-1 from predict_dist_table and suggest_table without an image or a
    net; -1 from the click+suggest click without an image, a net, a dist
    map or a previous frame; the same from both packages."""
    jax_win, port_win = _window(None)
    table = _table(2)
    for cls, dcls, win, kw in (
            (japi.ColorizeImageJax, japi.ColorizeImageJaxDist, jax_win, {}),
            (ColorizeImageTorch, ColorizeImageTorchDist, port_win,
             {"device": "cpu"})):
        m, d = cls(Xd=XD, **kw), dcls(Xd=XD, **kw)
        click = lambda: m.net_forward_table_win_suggest(  # noqa: E731
            *table, *win, d, 10, 12, K=3, N=1000)
        assert d.predict_dist_table(*table) == -1          # no image
        assert d.suggest_table(*table, 3, 4) == -1
        assert click() == -1
        assert m.net_forward_table_win(*table, *win) == -1
        im = _image(7, XD, XD)
        m.set_image(im)
        d.set_image(im)
        assert d.predict_dist_table(*table) == -1          # no net
        assert d.suggest_table(*table, 3, 4) == -1
        assert click() == -1
        m.prep_net(path=STUDENT)
        d.prep_net(path=STUDENT)
        assert click() == -1                               # no dist map
        assert d.predict_dist_table(*table) == 0
        assert click() == -1                               # no previous frame
        assert m.net_forward_table(*table).shape == (XD, XD, 3)
        win_frame, colors = click()
        assert colors.shape == (4, 3)
        # a dist-prepped model has no table program to click with
        assert d.net_forward_table_win_suggest(
            *table, *win, d, 10, 12) == -1


@pytest.mark.parametrize("K,N,name", [(0, 25000, "k"), (26, 25000, "k"),
                                      (9, 999, "N"), (9, 100001, "N")])
def test_ensure_suggest_program_validates_like_jax(jax_pair, K, N, name):
    _, jd = jax_pair
    _, td = _torch_pair()
    with pytest.raises(ValueError) as want:
        jd.ensure_suggest_program(K, N)
    with pytest.raises(ValueError) as got:
        td.ensure_suggest_program(K, N)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(f"{name} must be in")
    td.set_image(_image(8, XD, XD))
    with pytest.raises(ValueError):
        td.suggest_table(*_table(1), 3, 4, K=K, N=N)
    assert callable(td.ensure_suggest_program(25, 100000))


def test_suggest_table_contract(jax_pair):
    """suggest_table returns ((K,3) uint8, (K,) f32) like JAX's, with
    confidences that sum to 1 within 1e-5 and are sorted; it leaves the
    map set, equal to predict_dist_table's for the same table, and the hint
    mirrors too."""
    _, jd = jax_pair
    _, td = _torch_pair()
    im, table = _image(9, XD, XD), _table(3, seed=3)
    outs = []
    for d in (jd, td):
        d.set_image(im)
        colors, conf = d.suggest_table(*table, 20, 33, K=6, N=5000)
        assert colors.shape == (6, 3) and colors.dtype == np.uint8
        assert conf.shape == (6,) and conf.dtype == np.float32
        assert abs(conf.sum() - 1) < 1e-5 and (np.diff(conf) <= 0).all()
        assert d.dist_ab_set
        outs.append(d.dist_ab)
    assert np.abs(outs[1] - outs[0]).max() <= MAP_BOUND
    assert np.array_equal(td.input_mask, jd.input_mask)
    by_suggest = td.dist_ab
    td.predict_dist_table(*table)
    assert np.array_equal(td.dist_ab, by_suggest)
    centers, conf = td.get_ab_reccs(20, 33, K=4, N=5000, return_conf=True)
    assert centers.shape == (4, 2) and np.abs(centers).max() <= 110
    assert td.get_ab_reccs(20, 33, K=4, N=5000).shape == (4, 2)


def test_suggest_table_palette_is_the_bin_color_on_a_peaked_map():
    """With the dist forward replaced by a map peaked at one bin, the first
    palette color is lab_to_rgb_u8 of that bin at the click pixel's L,
    within 1 LSB, and its confidence > 0.99."""
    _, td = _torch_pair()
    td.set_image(_image(10, XD, XD))
    peaked = torch.full((16, 16, 529), 1e-9)
    peaked[5, 8, 300] = 1.0
    peaked /= peaked.sum(-1, keepdim=True)
    td._dist_fwd_tbl = lambda l_mc, ab, mask: peaked
    colors, conf = td.suggest_table(*_table(0), 22, 35, K=3)
    assert conf[0] > 0.99
    lab = torch.tensor([float(td.img_l[0, 22, 35]),
                        *td.pts_in_hull[300].tolist()])
    want = tcs.lab_to_rgb_u8(lab).numpy()
    assert np.abs(colors[0].astype(int) - want.astype(int)).max() <= 1


def test_window_click_matches_jax(jax_pair):
    """net_forward_table_win with the GUI's cubic matrices for a 96x80
    window: the window frame within 1 LSB on < 1e-3 of its pixels of JAX's
    (measured: 1 LSB on 2.6e-4 of them); the net frame, read lazily from
    output_rgb, byte-identical to the port's own net_forward_table for the same
    table."""
    jm, _ = jax_pair
    tm, _ = _torch_pair()
    im, table = _image(11, XD, XD), _table(5, seed=4)
    jax_win, port_win = _window(im)
    jm.set_image(im)
    tm.set_image(im)
    want = jm.net_forward_table_win(*table, *jax_win)[:WIN_HW[0], :WIN_HW[1]]
    got = tm.net_forward_table_win(*table, *port_win)
    assert got.shape == WIN_HW + (3,) and got.dtype == np.uint8
    worst, share = _lsb(got, want)
    assert worst <= 1 and share < 1e-3
    assert tm._output_rgb_np is None                   # not read back yet
    net = tm.output_rgb
    assert net is tm.output_rgb and net.shape == (XD, XD, 3)
    out_ab = tm.output_ab.copy()
    assert np.array_equal(tm.net_forward_table(*table), net)
    assert np.array_equal(tm.output_ab, out_ab)
    assert np.array_equal(tm.input_mask, jm.input_mask)
    assert _lsb(net, jm.output_rgb)[0] <= 1
    # tensors on the device are taken as they are
    as_tensors = tuple(torch.as_tensor(x) for x in port_win)
    assert np.array_equal(tm.net_forward_table_win(*table, *as_tensors), got)


def test_click_suggest_click(jax_pair):
    """net_forward_table_win_suggest: the same two frames as the window
    click for the same table, colors (K+1,3) f32 in [0,1] with row 0 the
    PREVIOUS frame's pixel / 255 exactly (JAX's own: within 1e-6); JAX's
    call gives the same shapes, its window frame within 1 LSB on < 1e-3 of
    the pixels and its row 0 within 1/255."""
    jm, jd = jax_pair
    tm, td = _torch_pair()
    im, t0, t1 = _image(12, XD, XD), _table(2, seed=5), _table(3, seed=5)
    jax_win, port_win = _window(im)
    h, w = 41, 17
    outs = []
    for m, d, win in ((jm, jd, jax_win), (tm, td, port_win)):
        m.set_image(im)
        d.set_image(im)
        d.predict_dist_table(*t0)
        prev = m.net_forward_table(*t0).copy()
        frame, colors = m.net_forward_table_win_suggest(
            *t1, *win, d, h, w, K=9, N=25000)
        assert colors.shape == (10, 3) and colors.dtype == np.float32
        assert colors.min() >= 0 and colors.max() <= 1
        cur = prev[h, w].astype(np.float32) / 255
        if m is tm:
            assert np.array_equal(colors[0], cur)
        else:                      # XLA multiplies by 1/255: 1 ulp off
            assert np.abs(colors[0] - cur).max() <= 1e-6
        outs.append((frame[:WIN_HW[0], :WIN_HW[1]], colors, m.output_rgb))
    (want_win, want_colors, want_net), (got_win, got_colors, got_net) = outs
    worst, share = _lsb(got_win, want_win)
    assert worst <= 1 and share < 1e-3
    assert np.abs(got_colors[0] - want_colors[0]).max() <= 1 / 255 + 1e-7
    assert np.array_equal(tm.net_forward_table_win(*t1, *port_win), got_win)
    assert np.array_equal(tm.output_rgb, got_net)
    assert np.array_equal(tm.net_forward_table(*t1), got_net)
    # the previous frame as numpy only (no device copy) serves too
    tm.output_rgb = got_net
    _, colors = tm.net_forward_table_win_suggest(*t1, *port_win, td, h, w,
                                                 K=2, N=1000)
    assert np.array_equal(colors[0], got_net[h, w].astype(np.float32) / 255)


def test_click_suggest_first_color_on_a_peaked_map():
    """On a map peaked at one bin the first suggestion equals lab_to_rgb of
    that bin at the click pixel's L, within 1/255 (measured 0.0: the
    cluster center is the bin itself)."""
    tm, td = _torch_pair()
    im = _image(13, XD, XD)
    _, port_win = _window(im)
    tm.set_image(im)
    td.set_image(im)
    tm.net_forward_table(*_table(0))
    peaked = torch.full((16, 16, 529), 1e-9)
    peaked[9, 3, 222] = 1.0
    td._dev_dist = peaked / peaked.sum(-1, keepdim=True)
    h, w = 9 * 4 + 2, 3 * 4 + 1                       # inside cell (9, 3)
    _, colors = tm.net_forward_table_win_suggest(*_table(1), *port_win, td,
                                                 h, w, K=3)
    lab = torch.tensor([float(tm.img_l[0, h, w]),
                        *td.pts_in_hull[222].tolist()])
    want = tcs.lab_to_rgb(lab).clamp(0, 1).numpy()
    assert np.abs(colors[1] - want).max() <= 1 / 255


def test_each_model_owns_a_generator_seeded_0():
    """The same seed gives the same suggestions from two fresh models; a
    model's draws advance only its own generator."""
    a, b = (ColorizeImageTorchDist(Xd=XD, device="cpu") for _ in range(2))
    assert a._generator is not b._generator
    assert a._generator.initial_seed() == b._generator.initial_seed() == 0
    for d in (a, b):
        d.prep_net(path=STUDENT)
        d.set_image(_image(14, XD, XD))
        d.predict_dist_table(*_table(2))
    first = a.get_ab_reccs(30, 30, K=5, N=2000, return_conf=True)
    second = a.get_ab_reccs(30, 30, K=5, N=2000, return_conf=True)
    other = b.get_ab_reccs(30, 30, K=5, N=2000, return_conf=True)
    assert np.array_equal(first[0], other[0])
    assert np.array_equal(first[1], other[1])
    assert not np.array_equal(first[0], second[0])


def test_lab2rgb_transpose_matches_jax():
    """(1,H,W) L + (2,H,W) ab -> (H,W,3) uint8 through K2's compose: within
    1 LSB on < 1e-3 of the pixels of JAX's (measured: identical)."""
    rng = np.random.default_rng(15)
    l = rng.uniform(0, 100, (1, 20, 30)).astype(np.float32)
    ab = rng.uniform(-90, 90, (2, 20, 30)).astype(np.float32)
    got = tcolorize.lab2rgb_transpose(l, ab, device="cpu")
    want = jcolorize.lab2rgb_transpose(l, ab)
    assert got.shape == (20, 30, 3) and got.dtype == np.uint8
    worst, share = _lsb(got, want)
    assert worst <= 1 and share < 1e-3


def test_plot_methods_draw(jax_pair):
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    _, td = _torch_pair()
    td.set_image(_image(16, XD, XD))
    td.predict_dist_table(*_table(1))
    td.compute_entropy()
    td.plot_dist_grid(10, 12)
    td.plot_dist_entropy()
    assert len(plt.get_fignums()) >= 2
    plt.close("all")
