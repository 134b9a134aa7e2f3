"""The port's ops/kmeans.py against the JAX package's, on the CPU.

JAX's PRNG and torch's give different streams, so the deterministic cores
are held exactly on shared random numbers (the uniforms of the sampler, the
seeds of Lloyd) and the random whole statistically."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ideepcolor_tpu.data import color_bins as jbins
from ideepcolor_tpu.ops import kmeans as jkm
from ideepcolor_tpu_torch.engine import pipeline as tP
from ideepcolor_tpu_torch.ops import kmeans as tkm

torch.set_num_threads(2)
PTS = jbins.get_bins().pts_in_hull.astype(np.float32)            # (313, 2)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _pdf(kind):
    rng = np.random.default_rng(11)
    if kind == "peaked":
        pdf = np.full(313, 1e-6, np.float32)
        pdf[[40, 41, 250, 251]] = [0.45, 0.1, 0.35, 0.1]
    elif kind == "three":
        pdf = np.full(313, 1e-6, np.float32)
        pdf[[30, 150, 151, 290]] = [0.4, 0.2, 0.1, 0.3]
    else:
        pdf = rng.random(313).astype(np.float32) + 0.05
    return pdf / pdf.sum()


def _inertia(centers, counts):
    d2 = ((PTS[:, None] - np.asarray(centers)[None]) ** 2).sum(-1)
    return float((np.asarray(counts, np.float64) * d2.min(1)).sum())


@pytest.mark.parametrize("kind", ["peaked", "broad"])
def test_bins_from_uniform_equals_jax_sample_bins(kind):
    """The same uniform numbers give the same histogram, exactly (measured:
    0 of 25000 samples land in another bin on either pdf; the two f32
    cumsums agree at every boundary a sample met)."""
    pdf, key = _pdf(kind), jax.random.key(3)
    u = np.array(jax.random.uniform(key, (25000,)))
    want = np.asarray(jkm.sample_bins(jnp.asarray(pdf), key, N=25000))
    got = tkm.bins_from_uniform(torch.from_numpy(pdf), torch.from_numpy(u))
    assert got.shape == (313,) and got.dtype == torch.int64
    assert int(got.sum()) == 25000
    assert np.array_equal(got.numpy(), want)


def test_bins_from_uniform_keeps_its_shape_at_u_of_one():
    """u = 1 would index one past the last bin: it is dropped, as
    jnp.bincount(length=Q) drops it, and the result stays (Q,)."""
    pdf = torch.tensor([0.25, 0.25, 0.5])
    got = tkm.bins_from_uniform(pdf, torch.tensor([0.0, 0.3, 0.6, 1.0]))
    assert got.tolist() == [1, 1, 1]


def test_sample_bins_statistics():
    pdf = np.zeros(313, np.float32)
    pdf[[10, 50, 200]] = [0.5, 0.3, 0.2]
    counts = tkm.sample_bins(torch.from_numpy(pdf), _gen(0), N=25000).numpy()
    assert counts.sum() == 25000
    for i, p in ((10, 0.5), (50, 0.3), (200, 0.2)):
        assert abs(counts[i] / 25000 - p) < 0.02
    assert counts[[0, 1, 2, 300]].sum() == 0


@pytest.mark.parametrize("kind", ["peaked", "broad"])
def test_lloyd_matches_jax_from_the_same_seeds(kind):
    """30 Lloyd steps from the same centers0 on the same counts: centers
    within 1e-3 (measured 0.0), mass equal, inertia within 1e-4
    relative (measured 7.6e-8). Also as a batch of two restarts."""
    rng = np.random.default_rng(5)
    w = rng.multinomial(25000, _pdf(kind)).astype(np.float32)
    c0 = PTS[rng.choice(313, (2, 5), replace=False)]
    for r in range(2):
        want = [np.asarray(x) for x in jkm._lloyd(
            jnp.asarray(PTS), jnp.asarray(w), jnp.asarray(c0[r]), 5, 30)]
        got = [x.numpy() for x in tkm._lloyd(
            torch.from_numpy(PTS), torch.from_numpy(w),
            torch.from_numpy(c0[r]), 5, 30)]
        assert np.abs(got[0] - want[0]).max() <= 1e-3
        assert np.array_equal(got[1], want[1])
        assert abs(got[2] - want[2]) <= 1e-4 * want[2]
    both = tkm._lloyd(torch.from_numpy(PTS), torch.from_numpy(w),
                      torch.from_numpy(c0), 5, 30)
    assert both[0].shape == (2, 5, 2) and both[1].shape == (2, 5)
    assert both[2].shape == (2,)
    assert torch.equal(both[0][1], torch.from_numpy(got[0]))


def test_lloyd_keeps_the_center_of_an_empty_cluster():
    pts = torch.tensor([[0.0, 0.0], [1.0, 0.0], [10.0, 0.0]])
    w = torch.tensor([1.0, 1.0, 2.0])
    c0 = torch.tensor([[0.0, 0.0], [10.0, 0.0], [500.0, 500.0]])
    centers, mass, _ = tkm._lloyd(pts, w, c0, 3, 5)
    assert centers[2].tolist() == [500.0, 500.0] and mass[2] == 0
    assert torch.allclose(centers[0], torch.tensor([0.5, 0.0]))


def test_seeds_from_uniform_picks_by_weight_then_by_distance():
    """The first seed by weight alone; the next ones never where no mass
    is or where a seed already sits; all mass on the seeds falls back to
    the weights (no NaN)."""
    pts = torch.tensor([[0.0, 0.0], [5.0, 5.0], [50.0, 50.0], [9.0, 9.0]])
    w = torch.tensor([1.0, 0.0, 3.0, 0.0])
    u = torch.tensor([[0.1, 0.5, 0.5], [0.9, 0.5, 0.99]])
    seeds = tkm.seeds_from_uniform(pts, w, u)
    assert seeds.shape == (2, 3, 2)
    assert seeds[0, 0].tolist() == [0.0, 0.0]         # u=0.1 of mass 4
    assert seeds[0, 1].tolist() == [50.0, 50.0]       # the only mass left
    assert seeds[1, 0].tolist() == [50.0, 50.0]
    assert seeds[1, 1].tolist() == [0.0, 0.0]
    assert torch.isfinite(seeds).all()
    for s in seeds.reshape(-1, 2).tolist():           # the degenerate pick
        assert s in ([0.0, 0.0], [50.0, 50.0])


def test_weighted_kmeans_separated_clusters():
    """The case the JAX package pins for its own function: same centers
    (atol 1.0) and fractions (1e-5) from both."""
    pts = np.array([[-80.0, -80.0], [-78.0, -78.0], [60.0, 70.0],
                    [62.0, 72.0], [0.0, 0.0]], np.float32)
    w = np.array([500.0, 500.0, 300.0, 300.0, 100.0], np.float32)
    want_c, want_f = (np.asarray(x) for x in jkm.weighted_kmeans(
        pts, w, jax.random.key(1), K=3))
    got_c, got_f = (x.numpy() for x in tkm.weighted_kmeans(
        torch.from_numpy(pts), torch.from_numpy(w), _gen(1), K=3))
    assert np.allclose(got_c, want_c, atol=1.0)
    assert np.allclose(got_c, [[-79, -79], [61, 71], [0, 0]], atol=1.0)
    assert np.allclose(got_f, want_f, atol=1e-5)
    assert np.allclose(got_f, [1000 / 1700, 600 / 1700, 100 / 1700],
                       atol=1e-5)


@pytest.mark.parametrize("kind,modes", [("peaked", 2), ("three", 3)])
def test_ab_recommendations_agree_with_jax(kind, modes):
    """The whole chain, each package on its own random numbers: the modes'
    centers within 6 ab (the bar the JAX package holds itself to against
    sklearn; measured 0.011), their confidences within 0.02 (measured
    0.0088), which sum to 1 and are sorted descending."""
    pdf = _pdf(kind)
    want_c, want_f = (np.asarray(x) for x in jkm.ab_recommendations(
        jnp.asarray(pdf), jnp.asarray(PTS), jax.random.key(2), K=5))
    got_c, got_f = (x.numpy() for x in tkm.ab_recommendations(
        torch.from_numpy(pdf), torch.from_numpy(PTS), _gen(2), K=5))
    assert got_c.shape == (5, 2) and got_f.shape == (5,)
    for k in range(modes):
        assert np.linalg.norm(got_c[k] - want_c[k]) < 6.0
        assert abs(got_f[k] - want_f[k]) < 0.02
    assert abs(got_f.sum() - 1.0) < 1e-5
    assert (np.diff(got_f) <= 0).all()
    assert np.abs(got_c).max() <= 110.0


def test_kmeans_inertia_within_5_percent_of_jax_over_8_seeds():
    """On JAX's own counts of a broad pdf, K=9 as the GUI asks: the port's
    best-of-4 inertia is within 5% of JAX's for each of 8 seeds (measured:
    between -1.9% and +3.0%)."""
    pdf = _pdf("broad")
    for seed in range(8):
        k1, k2 = jax.random.split(jax.random.key(seed))
        counts = np.asarray(jkm.sample_bins(jnp.asarray(pdf), k1, N=25000))
        want_c, _ = jkm.weighted_kmeans(jnp.asarray(PTS),
                                        jnp.asarray(counts), k2, K=9)
        got_c, got_f = tkm.weighted_kmeans(
            torch.from_numpy(PTS), torch.from_numpy(counts), _gen(seed), K=9)
        assert abs(float(got_f.sum()) - 1.0) < 1e-5
        assert _inertia(got_c.numpy(), counts) <= \
            1.05 * _inertia(want_c, counts), seed


def test_same_generator_seed_gives_the_same_result():
    pdf, pts = torch.from_numpy(_pdf("broad")), torch.from_numpy(PTS)
    a = tkm.ab_recommendations(pdf, pts, _gen(7), K=9)
    b = tkm.ab_recommendations(pdf, pts, _gen(7), K=9)
    c = tkm.ab_recommendations(pdf, pts, _gen(8), K=9)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_pipeline_suggest_at_peaked_dist():
    """engine.pipeline.suggest_at: gather + sample + k-means at a pixel."""
    dist = np.full((8, 8, 313), 1e-9, np.float32)
    dist[3, 4, 120] = 1.0
    dist /= dist.sum(-1, keepdims=True)
    centers, conf = tP.suggest_at(torch.from_numpy(dist), 3, 4,
                                  torch.from_numpy(PTS), _gen(0), K=3)
    assert np.allclose(centers[0].numpy(), PTS[120], atol=0.5)
    assert conf[0] > 0.99
