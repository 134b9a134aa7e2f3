"""The port's gamut helpers (ops/gamut.py, data/lab_gamut.py) and the two
resize helpers, against the JAX package's, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ideepcolor_tpu.data import lab_gamut as jlg
from ideepcolor_tpu.ops import gamut as jgamut
from ideepcolor_tpu.ops import resize as jresize
from ideepcolor_tpu_torch.data import lab_gamut as tlg
from ideepcolor_tpu_torch.ops import gamut as tgamut
from ideepcolor_tpu_torch.ops import resize as tresize

torch.set_num_threads(2)
LS = (20.0, 50.0, 80.0)


def _colors(n=64, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("l_in", LS)
def test_snap_ab_single_colors_equal_jax(l_in):
    """64 seeded colors, one at a time through the host wrapper: identical
    uint8 (measured: 0 of 192 values differ at each L)."""
    for c in _colors():
        want = jlg.snap_ab(l_in, c)
        got = tlg.snap_ab(l_in, c, device="cpu")
        assert got.dtype == np.uint8 and got.shape == (3,)
        assert np.array_equal(got, want), (l_in, c)


@pytest.mark.parametrize("l_in", LS)
def test_snap_ab_batch_stops_jointly_like_jax(l_in):
    """As one batch the stop is joint (the largest delta of the batch):
    identical to JAX's batch (measured: 0 values differ). It is not the
    colors snapped one by one (measured: 3 to 11 of 192 values differ)."""
    c = _colors()
    want = np.asarray(jgamut.snap_ab(jnp.float32(l_in), jnp.asarray(c)))
    got = tgamut.snap_ab(l_in, torch.from_numpy(c)).numpy()
    assert got.shape == (64, 3)
    assert np.array_equal(got, want)
    assert (got == np.round(got)).all() and got.min() >= 0 and got.max() <= 255


def test_snap_ab_per_color_lightness_and_lab_return():
    """A lightness per color, and return_type='lab': within 1e-3 of JAX
    (measured 3.1e-5); the snapped color has the asked L within the uint8
    round trip's 0.5."""
    c = _colors(16, seed=1)
    l = np.linspace(10, 90, 16).astype(np.float32)
    want = np.asarray(jgamut.snap_ab_lab(jnp.asarray(l), jnp.asarray(c)))
    got = tgamut.snap_ab_lab(torch.from_numpy(l), torch.from_numpy(c)).numpy()
    assert np.abs(got - want).max() <= 1e-3
    got1 = tlg.snap_ab(50.0, c[0], return_type="lab", device="cpu")
    assert np.abs(got1 - jlg.snap_ab(50.0, c[0], return_type="lab")).max() \
        <= 1e-3
    assert abs(got1[0] - 50.0) < 0.5


def test_1d_converters_match_jax():
    """rgb2lab_1d on uint8 and on float-in-[0,1], lab2rgb_1d rounding to
    uint8, and qcolor2lab_1d on any object with red()/green()/blue():
    Lab within 1e-3 (measured 3.1e-5), uint8 identical."""
    class Color:
        def red(self): return 200
        def green(self): return 30
        def blue(self): return 90
    for rgb in (np.array([200, 30, 90], np.uint8),
                np.array([0.2, 0.9, 0.4]), np.array([1, 1, 1], np.uint8)):
        d = np.abs(tlg.rgb2lab_1d(rgb, device="cpu") - jlg.rgb2lab_1d(rgb))
        assert d.max() <= 1e-3
    assert np.allclose(tlg.qcolor2lab_1d(Color(), device="cpu"),
                       tlg.rgb2lab_1d(np.array([200, 30, 90], np.uint8),
                                      device="cpu"))
    rng = np.random.default_rng(2)
    for _ in range(20):
        lab = np.array([rng.uniform(0, 100), *rng.uniform(-90, 90, 2)])
        assert np.array_equal(tlg.lab2rgb_1d(lab, device="cpu"),
                              jlg.lab2rgb_1d(lab))
    f = tlg.lab2rgb_1d([50, 10, 10], dtype="float", device="cpu")
    assert f.dtype == np.float32 and 0 <= f.min() and f.max() <= 1


@pytest.mark.parametrize("l_in", LS)
def test_ab_gamut_mask_matches_jax(l_in):
    """The 221x221 mask at fixed L: equal on all but < 1e-3 of the cells
    (measured: 0 cells differ), the masked RGB within 1 LSB where both are
    in gamut (measured: identical at L=20 and 80, 1 LSB at L=50)."""
    want_rgb, want_mask = (np.asarray(x) for x in
                           jgamut.ab_gamut_mask(jnp.float32(l_in)))
    got_rgb, got_mask = (x.numpy() for x in
                         tgamut.ab_gamut_mask(l_in, device="cpu"))
    assert got_rgb.shape == (221, 221, 3) and got_rgb.dtype == np.uint8
    assert got_mask.shape == (221, 221) and got_mask.dtype == bool
    assert np.mean(got_mask != want_mask) < 1e-3
    both = got_mask & want_mask
    assert 0.05 < both.mean() < 0.9
    d = np.abs(got_rgb.astype(int) - want_rgb.astype(int))
    assert d[both].max() <= 1
    assert (got_rgb[~got_mask] == 255).all()


def test_ab_gamut_mask_truncates_where_snap_ab_rounds():
    """ab_gamut_mask floors x255 and snap_ab rounds it: in-gamut cells of
    the mask equal the truncated compose, not the rounded one."""
    from ideepcolor_tpu_torch.ops import colorspace as cs
    rgb, mask = tgamut.ab_gamut_mask(50.0, device="cpu")
    r = torch.arange(-110, 111, dtype=torch.float32)
    a, b = torch.meshgrid(r, r, indexing="ij")
    x255 = cs.lab_to_rgb(torch.stack([torch.full_like(a, 50.0), a, b], -1)
                         ) * 255.0
    assert torch.equal(rgb[mask], torch.floor(x255)[mask].to(torch.uint8))
    assert not torch.equal(rgb[mask], torch.round(x255)[mask].to(torch.uint8))


def test_abgrid_matches_jax():
    want, got = jlg.abGrid(), tlg.abGrid(device="cpu")
    assert (got.A, got.B, got.AB) == (want.A, want.B, want.AB) == (221, 221,
                                                                   221 * 221)
    assert np.array_equal(got.pts_full_grid, want.pts_full_grid)
    w_rgb, w_mask = want.update_gamut(50.0)
    g_rgb, g_mask = got.update_gamut(50.0)
    assert np.mean(g_mask != w_mask) < 1e-3
    assert got.update_gamut(50.0)[0] is g_rgb                # memoized per L
    assert got.ab2xy(10, -20) == want.ab2xy(10, -20)
    assert got.xy2ab(3, 7) == want.xy2ab(3, 7)


@pytest.mark.parametrize("n_in,n_out", [(64, 96), (64, 80), (256, 512),
                                        (256, 100), (1, 5), (7, 7)])
def test_cubic_resize_matrix_equals_jax(n_in, n_out):
    """The port builds at the exact size; JAX's bucket-padded rows are the
    port's rows plus zero rows."""
    got = tresize.cubic_resize_matrix_np(n_in, n_out)
    assert got.shape == (n_out, n_in) and got.dtype == np.float32
    assert np.array_equal(got, jresize.cubic_resize_matrix_np(n_in, n_out))
    padded = jresize.cubic_resize_matrix_np(n_in, n_out, n_out + 32)
    assert np.array_equal(padded[:n_out], got)
    assert not padded[n_out:].any()
    assert np.allclose(got.sum(1), 1.0, atol=1e-6)


def test_upsample_nearest_equals_jax():
    x = np.random.default_rng(3).random((2, 5, 6, 3)).astype(np.float32)
    got = tresize.upsample_nearest(torch.from_numpy(x), 4).numpy()
    assert got.shape == (2, 20, 24, 3)
    assert np.array_equal(got, np.asarray(
        jresize.upsample_nearest(jnp.asarray(x), 4)))
    nchw = tresize.upsample_nearest(torch.from_numpy(x), 2, h_axis=-2,
                                    w_axis=-1)
    assert nchw.shape == (2, 5, 12, 6)
    assert torch.equal(nchw[..., ::2, ::2], torch.from_numpy(x))
