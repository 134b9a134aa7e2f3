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
