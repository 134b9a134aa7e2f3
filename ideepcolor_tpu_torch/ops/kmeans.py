"""Color-suggestion sampling on the device: CMF inverse transform + k-means.

Counterpart of ``ideepcolor_tpu/ops/kmeans.py``: cumsum the per-pixel bin
pdf, inverse-transform sample N ab points, k-means(K) with k-means++ seeding
and restarts, clusters sorted by occupancy. Samples take only as many
distinct values as there are bins, so Lloyd runs on the *weighted bins* (the
histogram of sampled bin indices), which is the same problem as k-means on
the raw samples.

Randomness comes from a ``torch.Generator`` on the tensors' device, passed
in where the JAX functions take a key. Each random function is split: its
deterministic core takes the uniform numbers (:func:`bins_from_uniform`,
:func:`seeds_from_uniform`, :func:`kmeans_from_uniform`) or the seeds
(:func:`_lloyd`) as input, and :func:`ab_recommendations` can hand back the
numbers it drew, so a caller can work its answer out again.

On the card :func:`ab_recommendations` runs everything after its draws as
one launch of kernel K5 (``ops.cuda.kmeans_kernel``), whose plain version
is the chain here. Run eagerly the chain's cost is its launches; inside a
click it is part of the click's captured CUDA graph (``engine.graphs``).
The restarts are a leading tensor dimension, the Lloyd iterations and the
K-1 seeding picks are the only Python loops, and nothing in them reads a
value back to the host, which capture forbids: the degenerate-mass and
empty-cluster branches are ``torch.where``, the winning restart is gathered
by a device index.
"""

from __future__ import annotations

import torch

from .cuda import kmeans_kernel as k5

RESTARTS = 4      # k-means restarts of a suggestion, the best one kept


def bins_from_uniform(pdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Histogram of the inverse-transform samples of uniform numbers ``u``
    (N,) in [0, 1) from a (Q,) pdf: u falls in bin i iff
    cmf[i-1] <= u < cmf[i]. Returns (Q,) int64 counts, sum = N."""
    Q = pdf.shape[0]
    cmf = torch.cumsum(pdf.to(torch.float32), 0)
    cmf = cmf / cmf[-1]
    inds = torch.searchsorted(cmf, u, right=True)
    # a slot past the end takes an index of Q (u >= 1) and is dropped, so
    # the result is (Q,) whatever u holds; scatter_add needs no readback of
    # the largest index, as torch.bincount would
    counts = torch.zeros(Q + 1, dtype=torch.int64, device=pdf.device)
    return counts.scatter_add_(0, inds, torch.ones_like(inds))[:Q]


def sample_bins(pdf: torch.Tensor, generator: torch.Generator,
                N: int = 25000) -> torch.Tensor:
    """Histogram of N inverse-transform samples from a (Q,) pdf."""
    u = torch.rand(N, generator=generator, device=pdf.device)
    return bins_from_uniform(pdf, u)


def _pick(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One index per row of nonnegative weights p (R, P), drawn by inverse
    transform from the uniform numbers u (R,)."""
    c = torch.cumsum(p, 1)
    idx = torch.searchsorted(c, (u * c[:, -1])[:, None], right=True)[:, 0]
    return idx.clamp_(max=p.shape[1] - 1)


def seeds_from_uniform(pts: torch.Tensor, w: torch.Tensor,
                       u: torch.Tensor) -> torch.Tensor:
    """k-means++ seeding over weighted support points, for R restarts at
    once: pts (P, C), w (P,), u (R, K) uniform numbers -> (R, K, C) seeds.
    The first seed is drawn by weight, each next one by weight times the
    squared distance to the nearest seed so far."""
    R, K = u.shape
    seed = pts[_pick(w.expand(R, -1), u[:, 0])]               # (R, C)
    seeds = [seed]
    dmin = ((pts[None] - seed[:, None]) ** 2).sum(-1)          # (R, P)
    for i in range(1, K):
        p = w * dmin
        # degenerate: all mass already sits on a seed
        p = torch.where(p.sum(1, keepdim=True) > 0, p, w)
        seed = pts[_pick(p, u[:, i])]
        seeds.append(seed)
        dmin = torch.minimum(dmin, ((pts[None] - seed[:, None]) ** 2).sum(-1))
    return torch.stack(seeds, 1)


def _lloyd(pts: torch.Tensor, w: torch.Tensor, centers0: torch.Tensor,
           K: int, iters: int):
    """``iters`` Lloyd steps from ``centers0`` (..., K, C), any leading
    restart dimensions. An empty cluster keeps its center. Returns
    (centers (..., K, C), mass (..., K), inertia (...))."""
    slots = torch.arange(K, device=pts.device)

    def assign(centers):
        d2 = ((pts[:, None, :] - centers[..., None, :, :]) ** 2).sum(-1)
        onehot = (d2.argmin(-1, keepdim=True) == slots).to(torch.float32)
        return d2, onehot * w[:, None]                       # (..., P, K)

    centers = centers0
    for _ in range(iters):
        _, onehot = assign(centers)
        mass = onehot.sum(-2)                                # (..., K)
        newc = (onehot.transpose(-1, -2) @ pts
                ) / mass.clamp_min(1e-12)[..., None]
        centers = torch.where((mass > 0)[..., None], newc, centers)
    d2, onehot = assign(centers)
    inertia = (w * d2.min(-1).values).sum(-1)
    return centers, onehot.sum(-2), inertia


def kmeans_from_uniform(points: torch.Tensor, weights: torch.Tensor,
                        u: torch.Tensor, iters: int = 30):
    """:func:`weighted_kmeans`'s deterministic core: the (restarts, K)
    uniform numbers u give the k-means++ seeds of each restart."""
    pts = points.to(torch.float32)
    w = weights.to(torch.float32)
    c0 = seeds_from_uniform(pts, w, u)
    centers_all, mass_all, inertia_all = _lloyd(pts, w, c0, u.shape[1], iters)
    # a gather by a device index: indexing with the 0-d tensor itself would
    # read it back to the host, which also forbids capture in a CUDA graph
    best = inertia_all.argmin().reshape(1)
    centers = centers_all.index_select(0, best)[0]
    mass = mass_all.index_select(0, best)[0]
    order = torch.argsort(-mass, stable=True)
    return centers[order], mass[order] / w.sum()


def weighted_kmeans(points: torch.Tensor, weights: torch.Tensor,
                    generator: torch.Generator, K: int = 5, iters: int = 30,
                    n_init: int = RESTARTS):
    """Weighted k-means with k-means++ seeding (sklearn's strategy, which
    the reference relies on for good suggestion clusters) and restarts.

    points (P, 2); weights (P,) nonnegative. The ``n_init`` restarts run as
    one batch; the lowest inertia wins (sklearn's n_init behavior, which the
    reference depends on). Returns (centers (K, 2) sorted by cluster
    occupancy, descending; occupancy fractions (K,))."""
    u = torch.rand((n_init, K), generator=generator, device=points.device)
    return kmeans_from_uniform(points, weights, u, iters)


def ab_recommendations(dist: torch.Tensor, centers_tbl: torch.Tensor,
                       generator: torch.Generator, K: int = 5,
                       N: int = 25000, iters: int = 30,
                       return_draws: bool = False):
    """The suggestion chain for one pixel's (Q,) bin distribution: sample N
    draws from the pdf, map to the ab bin centers, k-means(K), sort by
    occupancy. Returns (K, 2) ab centers + (K,) confidence fractions; with
    ``return_draws`` also the uniform numbers the chain drew, (N,) for the
    sampler and (RESTARTS, K) for the seeding, from which
    :func:`bins_from_uniform` and :func:`kmeans_from_uniform` give the same
    answer again.

    Where ``k5.engages`` (a pdf and table of one length on a CUDA device,
    a palette of at most 32), everything after the two draws is one launch
    of kernel K5 on their float32 values, as the chain takes them; elsewhere
    the chain runs."""
    u_bins = torch.rand(N, generator=generator, device=dist.device)
    u_seeds = torch.rand((RESTARTS, K), generator=generator,
                         device=centers_tbl.device)
    if k5.engages(dist, centers_tbl, K):
        packed = k5.suggest(dist.to(torch.float32),
                            centers_tbl.to(torch.float32), u_bins, u_seeds,
                            iters)
        out = packed[:, :2], packed[:, 2]
    else:
        out = kmeans_from_uniform(centers_tbl,
                                  bins_from_uniform(dist, u_bins), u_seeds,
                                  iters)
    return (*out, u_bins, u_seeds) if return_draws else out
