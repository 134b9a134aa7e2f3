"""The port's bin tables and ops/quantize.py against the JAX package's, on
the CPU: the same seeded numpy inputs through both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ideepcolor_tpu.data import color_bins as jbins
from ideepcolor_tpu.ops import quantize as jq
from ideepcolor_tpu_torch.data import color_bins as tbins
from ideepcolor_tpu_torch.ops import quantize as tq

torch.set_num_threads(2)


def _ab(seed, n=4000):
    """Random ab: most inside [-110, 110], a tenth far outside the hull."""
    rng = np.random.default_rng(seed)
    ab = rng.uniform(-110, 110, (n, 2)).astype(np.float32)
    ab[::10] = rng.uniform(-400, 400, (len(ab[::10]), 2))
    return ab


@pytest.mark.parametrize("order", ["ab", "ba"])
def test_grid_equals_jax(order):
    assert np.array_equal(tbins.make_grid(order), jbins.make_grid(order))


def test_hull_and_bins_equal_jax():
    assert np.array_equal(tbins.make_in_hull(), jbins.make_in_hull())
    got, want = tbins.get_bins(), jbins.get_bins()
    assert got.K == want.K == 313 == tbins.NUM_IN_HULL
    for f in ("pts_grid", "in_hull", "pts_in_hull"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_get_bins_is_built_once_from_grid_and_hull():
    b = tbins.get_bins()
    assert b is tbins.get_bins()                           # cached
    assert np.array_equal(b.pts_grid, tbins.make_grid("ab"))
    assert np.array_equal(b.pts_in_hull, b.pts_grid[tbins.make_in_hull()])
    assert b.in_hull.sum() == tbins.NUM_IN_HULL


def test_pts_grid_meshgrid_order():
    """The SIGGRAPH head's bins are in meshgrid order (b slow, a fast),
    which is make_grid('ba'), not the .npy tables' order."""
    g = tq.make_pts_grid()
    assert np.array_equal(g, jq.make_pts_grid())
    assert g.shape == (529, 2) and g.dtype == np.int64
    assert g[0].tolist() == [-110, -110] and g[1].tolist() == [-100, -110]
    assert g[23].tolist() == [-110, -100]
    assert np.array_equal(g, tbins.make_grid("ba"))
    assert not np.array_equal(g, tbins.make_grid("ab"))


def test_soft_encode_nn1_exact():
    """nn=1: the same one-hot for every point (measured: 0 of 4000 differ)."""
    ab = _ab(0)
    got = tq.soft_encode(torch.from_numpy(ab)).numpy()
    want = np.asarray(jq.soft_encode(jnp.asarray(ab)))
    assert got.shape == want.shape == (4000, 313)
    assert np.array_equal(got, want)


def test_soft_encode_nn5_matches_jax():
    """nn=5, points far outside the hull included: within 1e-6 (measured
    1.2e-7), finite, rows sum to 1."""
    ab = _ab(1).reshape(40, 100, 2)
    got = tq.soft_encode(torch.from_numpy(ab), nn=5).numpy()
    want = np.asarray(jq.soft_encode(jnp.asarray(ab), nn=5))
    assert got.shape == want.shape == (40, 100, 313)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(got.sum(-1) - 1).max() <= 1e-5
    assert ((got > 0).sum(-1) <= 5).all()


def test_decode_and_annealed_mean_match_jax():
    """decode and annealed_mean (T=2.6 and 0.2, bins last and first):
    within 1e-4 (measured 1.1e-5 for decode, 2.3e-5 for the mean)."""
    rng = np.random.default_rng(2)
    enc = rng.random((6, 7, 313)).astype(np.float32)
    enc /= enc.sum(-1, keepdims=True)
    d = np.abs(tq.decode(torch.from_numpy(enc)).numpy()
               - np.asarray(jq.decode(jnp.asarray(enc)))).max()
    assert d <= 1e-4
    logits = rng.normal(0, 3, (6, 7, 313)).astype(np.float32)
    for T in (2.6, 0.2):
        got = tq.annealed_mean(torch.from_numpy(logits), T).numpy()
        want = np.asarray(jq.annealed_mean(jnp.asarray(logits), T))
        assert got.shape == want.shape == (6, 7, 2)
        assert np.abs(got - want).max() <= 1e-4
    first = np.ascontiguousarray(logits.transpose(2, 0, 1))
    got = tq.annealed_mean(torch.from_numpy(first), 2.6, axis=0).numpy()
    want = np.asarray(jq.annealed_mean(jnp.asarray(first), 2.6, axis=0))
    assert got.shape == want.shape == (2, 6, 7)
    assert np.abs(got - want).max() <= 1e-4


def test_scatter_to_grid_exact():
    rng = np.random.default_rng(3)
    d = rng.random((313, 5, 4)).astype(np.float32)
    in_hull = tbins.get_bins().in_hull
    got = tq.scatter_to_grid(torch.from_numpy(d), in_hull).numpy()
    want = np.asarray(jq.scatter_to_grid(jnp.asarray(d), in_hull))
    assert got.shape == (23, 23, 5, 4)
    assert np.array_equal(got, want)
    assert np.array_equal(got.reshape(529, 5, 4)[in_hull], d)


def test_entropy_matches_jax():
    """sum p log p, the reference's sign: within 1e-5 (measured 1.4e-6)."""
    rng = np.random.default_rng(4)
    p = rng.random((313, 9, 8)).astype(np.float32) + 1e-3
    p /= p.sum(0, keepdims=True)
    got = tq.entropy(torch.from_numpy(p)).numpy()
    want = np.asarray(jq.entropy(jnp.asarray(p)))
    assert got.shape == (9, 8) and (got < 0).all()
    assert np.abs(got - want).max() <= 1e-5
