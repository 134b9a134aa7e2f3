"""Port colorspace, resize and pipeline helpers against the JAX package,
on the CPU, with seeded numpy inputs fed to both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ideepcolor_tpu.engine import pipeline as jP
from ideepcolor_tpu.ops import colorspace as jcs
from ideepcolor_tpu.ops import resize as jrs
from ideepcolor_tpu_torch.engine import pipeline as tP
from ideepcolor_tpu_torch.ops import colorspace as tcs
from ideepcolor_tpu_torch.ops import resize as trs

torch.set_num_threads(1)
RNG = np.random.default_rng(17)


def _rgb(shape):
    return RNG.random(shape).astype(np.float32)


def _lab(shape):
    return np.concatenate([RNG.uniform(0, 100, shape + (1,)),
                           RNG.uniform(-110, 110, shape + (2,))],
                          -1).astype(np.float32)


def test_rgb_to_lab_matches_jax():
    """pow(1/3) in place of cbrt: about 1 ulp of f, which is 6.1e-5 at
    most on L in [0, 100] here; bound 2e-4."""
    rgb = _rgb((120, 90, 3))
    got = tcs.rgb_to_lab(torch.from_numpy(rgb)).numpy()
    want = np.asarray(jcs.rgb_to_lab(jnp.asarray(rgb)))
    assert np.max(np.abs(got - want)) < 2e-4


def test_lab_to_rgb_matches_jax():
    """Same constants, same chain: 3.1e-6 at most here; bound 1e-5."""
    lab = _lab((120, 90))
    got = tcs.lab_to_rgb(torch.from_numpy(lab)).numpy()
    want = np.asarray(jcs.lab_to_rgb(jnp.asarray(lab)))
    assert np.max(np.abs(got - want)) < 1e-5


@pytest.mark.parametrize("hw", [(5, 7), (100, 128), (256, 256)])
def test_lab_to_rgb_u8_within_one_lsb(hw):
    """The truncating x255: <= 1 LSB on < 1e-3 of the pixels (measured
    8e-5 at most)."""
    lab = _lab(hw)
    got = tcs.lab_to_rgb_u8(torch.from_numpy(lab)).numpy().astype(int)
    want = np.asarray(jcs.lab_to_rgb_u8(jnp.asarray(lab))).astype(int)
    assert got.shape == hw + (3,)
    d = np.abs(got - want)
    assert d.max() <= 1 and np.mean(d != 0) < 1e-3


def test_white_point_truncates_as_the_jax_compose():
    """L=100, ab=0 sits on the 254/255 boundary; the port composes it as
    the JAX click does (its plain K2 and its colorspace module alike)."""
    from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as tck
    lab = np.zeros((4, 4, 3), np.float32)
    lab[..., 0] = 100.0
    want = np.asarray(jP.compose_rgb_u8(jnp.asarray(lab[..., :1]),
                                        jnp.asarray(lab[..., 1:])))
    t = torch.from_numpy(lab)
    assert np.array_equal(tcs.lab_to_rgb_u8(t).numpy(), want)
    assert np.array_equal(
        tck.compose_frame_u8(t[..., :1], t[..., 1:]).numpy(), want)


def test_requantized_ab_matches_jax():
    """ab of the uint8 frame's own Lab; same 2e-4 bound as rgb_to_lab."""
    rgb = RNG.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    got = tcs.requantized_ab(torch.from_numpy(rgb)).numpy()
    want = np.asarray(jP.requantized_ab(jnp.asarray(rgb)))
    assert got.shape == (64, 64, 2)
    assert np.max(np.abs(got - want)) < 2e-4


def test_image_prep_planes_match_jax():
    rgb = RNG.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    lab_t = tP.rgb_to_lab_dev_u8(torch.from_numpy(rgb))
    lab_j = jP.rgb_to_lab_dev_u8(jnp.asarray(rgb))
    assert np.max(np.abs(lab_t.numpy() - np.asarray(lab_j))) < 2e-4
    mc_t = tP.center_plane(lab_t, 50.0, 1.0).numpy()
    mc_j = np.asarray(jP.center_plane(lab_j, jnp.float32(50.0),
                                      jnp.float32(1.0)))
    assert mc_t.shape == (37, 53, 1)
    assert np.max(np.abs(mc_t - mc_j)) < 2e-4


@pytest.mark.parametrize("n_in,n_out,n_rows",
                         [(64, 150, None), (64, 97, 256), (1, 5, None),
                          (256, 1000, None), (7, 1, 3)])
def test_resize_matrices_equal_jax(n_in, n_out, n_rows):
    """The port builds at the exact size; JAX's bucket-padded matrix is the
    same rows followed by zero rows."""
    for ours, theirs in ((trs.linear_resize_matrix_np,
                          jrs.linear_resize_matrix_np),
                         (trs.nearest_resize_matrix_np,
                          jrs.nearest_resize_matrix_np)):
        got = ours(n_in, n_out)
        want = theirs(n_in, n_out, n_rows)
        assert got.shape == (n_out, n_in)
        assert np.array_equal(got, want[:n_out])
        assert not want[n_out:].any()


def test_zoom_with_matrices_matches_jax():
    x = _rgb((64, 48, 2))
    rh = jrs.linear_resize_matrix_np(64, 150)
    rw = jrs.linear_resize_matrix_np(48, 97)
    got = trs.zoom_with_matrices(torch.from_numpy(x), torch.from_numpy(rh),
                                 torch.from_numpy(rw)).numpy()
    want = np.asarray(jrs.zoom_with_matrices(jnp.asarray(x), jnp.asarray(rh),
                                             jnp.asarray(rw)))
    assert got.shape == (150, 97, 2)
    assert np.max(np.abs(got - want)) < 1e-5


@pytest.mark.parametrize("src_hw,out_hw",
                         [((150, 97), (64, 64)), ((1000, 750), (256, 256)),
                          ((40, 30), (64, 64)), ((128, 128), (64, 64)),
                          ((512, 300), (256, 256))])
def test_net_size_resize_bitexact_with_cv2(src_hw, out_hw):
    """The torch resize reproduces cv2.resize's fixed-point INTER_LINEAR:
    0 LSB apart (downscale, upscale, the exact-2x box case, 2x on one axis
    only)."""
    cv2 = pytest.importorskip("cv2")
    im = RNG.integers(0, 256, src_hw + (3,), dtype=np.uint8)
    got = trs.resize_u8_half_pixel(torch.from_numpy(im), out_hw).numpy()
    want = cv2.resize(im, (out_hw[1], out_hw[0]))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


def test_fullres_getters_match_jax_crops():
    """Exact-size full-res programs give the frames the JAX package crops
    out of its bucket-padded programs (<= 1 LSB)."""
    H, W, S = 150, 97, 64
    Hb, Wb = jP.bucket_size(H), jP.bucket_size(W)
    lab = _lab((H, W))
    l_pad = np.zeros((Hb, Wb, 1), np.float32)
    l_pad[:H, :W] = lab[..., :1]
    ab = RNG.uniform(-60, 60, (S, S, 2)).astype(np.float32)
    mask = (RNG.random((S, S, 1)) < 0.1).astype(np.float32)
    planes = np.concatenate([mask, ab], -1)
    lin, jlin = trs.linear_resize_matrix_np, jrs.linear_resize_matrix_np
    near, jnear = trs.nearest_resize_matrix_np, jrs.nearest_resize_matrix_np
    t = torch.from_numpy
    cases = [
        (tP.fullres_fuse(t(lab[..., :1]), t(ab), t(lin(S, H)), t(lin(S, W))),
         jP.fullres_fuse_bucketed(l_pad, ab, jlin(S, H, Hb), jlin(S, W, Wb))),
        (tP.mask_fullres(t(mask), t(near(S, H)), t(near(S, W))),
         jP.mask_fullres_bucketed(mask, jnear(S, H, Hb), jnear(S, W, Wb))),
        (tP.sup_fullres(t(planes), t(near(S, H)), t(near(S, W))),
         jP.sup_fullres_bucketed(planes, jnear(S, H, Hb),
                                 jnear(S, W, Wb))),
    ]
    for got, want in cases:
        got = got.numpy().astype(int)
        want = np.asarray(want)[:H, :W].astype(int)
        assert got.shape == (H, W, 3)
        d = np.abs(got - want)
        assert d.max() <= 1 and np.mean(d != 0) < 1e-3


def _hsv_cases():
    rgb = _rgb((40, 30, 3))
    rgb[0, 0] = 0.0                        # black: v == 0
    rgb[0, 1] = 0.5                        # gray: c == 0
    rgb[0, 2] = (0.7, 0.7, 0.2)            # r and g tie for the maximum
    rgb[0, 3] = (0.2, 0.7, 0.7)            # g and b tie
    rgb[0, 4] = (0.9, 0.1, 0.6)            # max red with b > g: (g-b)/c < 0
    rgb[0, 5] = 1.0
    return rgb


def test_rgb_to_hsv_matches_jax():
    """1e-6 (measured 0): the ``% 6`` of a negative hue term, the gray and
    black guards, and red tested before green on ties."""
    rgb = _hsv_cases()
    got = tcs.rgb_to_hsv(torch.from_numpy(rgb)).numpy()
    want = np.asarray(jcs.rgb_to_hsv(jnp.asarray(rgb)))
    assert np.abs(got - want).max() <= 1e-6
    assert got[0, 0].tolist() == [0.0, 0.0, 0.0]
    assert got[0, 1, 0] == 0.0 and got[0, 1, 1] == 0.0
    assert 0.5 < got[0, 4, 0] < 1.0        # wrapped into [0, 1), not negative
    assert got[..., 0].min() >= 0.0 and got[..., 0].max() < 1.0


def test_hsv_to_rgb_matches_jax_and_inverts():
    rgb = _hsv_cases()
    hsv = np.array(jcs.rgb_to_hsv(jnp.asarray(rgb)))
    hsv[1, 0] = (1.0, 0.5, 0.5)            # h == 1: sector 6 wraps to 0
    got = tcs.hsv_to_rgb(torch.from_numpy(hsv)).numpy()
    want = np.asarray(jcs.hsv_to_rgb(jnp.asarray(hsv)))
    assert np.abs(got - want).max() <= 1e-6
    back = tcs.hsv_to_rgb(tcs.rgb_to_hsv(torch.from_numpy(rgb))).numpy()
    assert np.abs(back - rgb).max() <= 1e-5


@pytest.mark.parametrize("hw", [(6, 8), (5, 7), (1, 1)])
def test_bilinear_up2_fixed_matches_jax(hw):
    """1e-6 at even and odd sizes (measured 6e-8); exactly twice the size;
    the input's type is kept."""
    x = RNG.standard_normal((2,) + hw + (5,)).astype(np.float32)
    want = np.asarray(jrs.bilinear_up2_fixed(jnp.asarray(x)))
    got = trs.bilinear_up2_fixed(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(got.shape) == (2, 5, 2 * hw[0], 2 * hw[1])
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() <= 1e-6
    half = trs.bilinear_up2_fixed(
        torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert half.dtype == torch.bfloat16


def test_bilinear_up2_fixed_impulse_lands_where_jax_puts_it():
    """An impulse at (2, 3) of an odd-sized plane: the kernel's 3x3 block of
    weights centered on (4, 6), its zero row and column on the far side. A
    flipped kernel would shift the block by one pixel."""
    x = np.zeros((1, 5, 7, 1), np.float32)
    x[0, 2, 3, 0] = 1.0
    got = trs.bilinear_up2_fixed(torch.from_numpy(x).permute(0, 3, 1, 2)
                                 )[0, 0].numpy()
    want = np.asarray(jrs.bilinear_up2_fixed(jnp.asarray(x)))[0, ..., 0]
    assert np.array_equal(got, want)
    block = np.array([[0.25, 0.5, 0.25], [0.5, 1.0, 0.5], [0.25, 0.5, 0.25]],
                     np.float32)
    expect = np.zeros((10, 14), np.float32)
    expect[3:6, 5:8] = block
    assert np.array_equal(got, expect)
    assert np.array_equal(np.asarray(trs.CAFFE_US_KERNEL, np.float32),
                          np.asarray(jrs.CAFFE_US_KERNEL))
