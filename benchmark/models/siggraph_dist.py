"""The reference application's PyTorch distribution backend
(``ColorizeImageTorchDist``, ``data/colorize_image.py:279-372``; Zhang et
al. 2017, arXiv:1705.02999): the SIGGRAPHGenerator with its class head, and
the color-suggestion chain a click runs at its pixel. FLOPs, weights and
the plain references of both.

The forward is ``models.siggraph``'s with ``dist=True``: the (N, 529, S/4,
S/4) map, softmax of the class head's logits x ``softmax_scale``, given
here bins last as the program keeps it. The chain is written here:

1. the pixel's pdf cumulated and normalized by its last value; draw u
   falls in bin i iff cmf[i-1] <= u < cmf[i] (``np.digitize``, as the
   reference application samples), counted per bin;
2. k-means++ seeding over the 529 bin centers weighted by their counts:
   the first seed by weight, each next by weight times the squared
   distance to the nearest seed so far, each by inverse transform of one
   draw;
3. ``lloyd_steps`` Lloyd steps from the seeds of each of ``restarts``
   restarts; an empty cluster keeps its center;
4. the restart of lowest inertia;
5. its clusters sorted by occupancy, largest first, each with its share
   of the draws.

Departures from the reference application's ``sklearn.cluster.KMeans``
(``n_init=10``, up to 300 steps until the centers move less than its
tolerance, greedy k-means++ with 2 + log K trials a pick, on the 25,000
samples themselves): 4 restarts (the port's setting), a fixed 30 steps, one
trial a pick, and k-means on the weighted bins, which is the same problem
as k-means on the samples, since a sample takes its bin's center. The
chain costs no FLOPs in :func:`flops`: it is a few million operations, all
of them in launches bound by latency.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from models import siggraph as net

load_weights = net.load_weights
precision = net.precision

# A float32 cumulative sum of n nonnegative terms is within (n - 1) x 2^-24
# of their total of the exact sum, in any order of summation: 3.2e-5 for the
# 529 bins. A seeding draw that falls nearer than this to the boundary of two
# bins' intervals may take either bin in float32, so both are followed.
SEED_TOL = 4e-5
# The inertia, a float32 sum of 529 terms, is as near to its exact value;
# restarts whose inertias lie within this of each other's may win either way
# round.
INERTIA_TOL = 1e-4
MAX_SEEDINGS = 64         # seedings followed per restart, at most


def flops(cfg: dict, size: int) -> float:
    """One predicting forward at ``size`` x ``size``: the trunk and the
    class head (2 x 256 x 529 x (size / 4)^2)."""
    return net.flops(cfg, size, dist=True)


def grid() -> np.ndarray:
    """(529, 2) float32 ab centers of the class head's bins, in its order:
    ``np.meshgrid`` of -110..110 step 10, a fast and b slow, as the
    reference application's ``pts_grid``."""
    r = np.arange(-110, 120, 10)
    return np.array(np.meshgrid(r, r)).reshape(2, -1).T.astype(np.float32)


def reference(w: dict, cfg: dict, l, ab, mask, prec: str) -> dict:
    """The prediction and the (N, S/4, S/4, bins) map at ``prec``:
    "float32" (the reference: TF32 off) or "tf32" (the control)."""
    if cfg["softmax_scale"] != 0.2:      # models.siggraph's, as published
        raise ValueError(f"softmax scale {cfg['softmax_scale']}, not 0.2")
    with precision("tf32" if prec == "tf32" else "float32"):
        pred, dist = net.forward(w, cfg, l, ab, mask, dist=True)
    return {"pred": pred, "map": dist.permute(0, 2, 3, 1)}


def counts(pdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Step 1: (Q,) float32 counts of the draws u (N,) under the (Q,)
    pdf."""
    cmf = torch.cumsum(pdf.to(torch.float32), 0)
    cmf = cmf / cmf[-1]
    idx = torch.searchsorted(cmf, u.to(torch.float32), right=True)
    Q = pdf.shape[0]
    return torch.bincount(idx, minlength=Q + 1)[:Q].to(torch.float32)


def _hits(c: np.ndarray, p: np.ndarray, x: float, tol: float) -> list:
    """Indices of the support points whose intervals of the exact
    cumulative sum ``c`` of weights ``p`` come within ``tol`` of ``x``
    (the point ``x`` itself falls in first); past the last, the last."""
    lo = int(np.searchsorted(c, x - tol, side="right"))
    hi = int(np.searchsorted(c, x + tol, side="right"))
    exact = int(np.searchsorted(c, x, side="right"))
    out = [min(exact, len(p) - 1)]
    for j in range(lo, hi + 1):
        j2 = min(j, len(p) - 1)
        if (j == len(p) or p[j] > 0) and j2 not in out:
            out.append(j2)
    return out


def seedings(pts: np.ndarray, w: np.ndarray, u: np.ndarray) -> list:
    """Step 2 for one restart: the (K, 2) seeds that the draws u (K,) give,
    the exact ones first, then each other seeding that a float32 sum could
    have picked (a draw within ``SEED_TOL`` of a boundary), at most
    ``MAX_SEEDINGS``. The weights and squared distances are integers, so
    the sums here are exact in float64."""
    pts64, w64 = pts.astype(np.float64), w.astype(np.float64)
    out = []

    def extend(chosen, dmin, i):
        if len(out) >= MAX_SEEDINGS:
            return
        if i == len(u):
            out.append(pts[chosen])
            return
        # the float32 product the program forms: exact in float64 after
        p = (w.astype(np.float32) * dmin.astype(np.float32)).astype(
            np.float64) if i else w64
        if p.sum() <= 0:
            p = w64
        c = np.cumsum(p)
        x = float(np.float32(u[i]) * np.float32(c[-1]))
        for j in _hits(c, p, x, SEED_TOL * c[-1]):
            d2 = ((pts64 - pts64[j]) ** 2).sum(1)
            extend(chosen + [j], d2 if not i else np.minimum(dmin, d2),
                   i + 1)

    extend([], None, 0)
    return out


def lloyd(pts: torch.Tensor, w: torch.Tensor, c: torch.Tensor, steps: int,
          prec: str = "float32"):
    """Step 3 for M seedings at once: pts (P, 2), w (M, P) counts, c (M, K,
    2) seeds -> (centers (M, K, 2), mass (M, K), inertia (M,)). The
    weighted sums are a matrix product, which ``prec`` "tf32" lets the card
    take in TF32."""
    K = c.shape[1]

    def assign(c):
        d2 = ((pts[None, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)
        onehot = F.one_hot(d2.argmin(-1), K).to(torch.float32) * w[..., None]
        return d2, onehot                                    # (M, P, K)

    with precision("tf32" if prec == "tf32" else "float32"):
        for _ in range(steps):
            _d2, onehot = assign(c)
            mass = onehot.sum(1)
            sums = onehot.transpose(1, 2) @ pts
            c = torch.where((mass > 0)[..., None], sums / mass[..., None], c)
    d2, onehot = assign(c)
    return c, onehot.sum(1), (w * d2.min(-1).values).sum(-1)


def palettes(pdf: torch.Tensor, pts: torch.Tensor, u_bins: torch.Tensor,
             u_seeds: torch.Tensor, steps: int, prec: str = "float32"
             ) -> list:
    """Every palette the chain may give for one pixel's pdf and its draws
    u_bins (N,) and u_seeds (restarts, K): [(centers (K, 2), shares (K,),
    counts (K,))], sorted by occupancy, numpy. More than one where float32
    rounding decides a choice: a seeding draw at a boundary (``seedings``)
    or two restarts whose inertias tie within ``INERTIA_TOL``."""
    w = counts(pdf, u_bins)
    w_np = w.cpu().numpy()
    pts_np = pts.cpu().numpy()
    u_np = u_seeds.cpu().numpy()
    runs = [seedings(pts_np, w_np, row) for row in u_np]
    seeds = torch.from_numpy(np.stack(list(itertools.chain(*runs)))).to(
        pts.device)
    c, mass, inertia = lloyd(pts, w.expand(len(seeds), -1), seeds, steps,
                             prec)
    c, mass, inertia = c.cpu().numpy(), mass.cpu().numpy(), \
        inertia.cpu().numpy().astype(np.float64)
    owner = np.repeat(np.arange(len(runs)), [len(r) for r in runs])
    worst = np.array([inertia[owner == r].max() for r in range(len(runs))])
    out = []
    for m in range(len(seeds)):
        others = np.delete(worst, owner[m])
        if len(others) and inertia[m] > (1 + INERTIA_TOL) * others.min():
            continue
        order = np.argsort(-mass[m], kind="stable")
        out.append((c[m][order], mass[m][order] / w_np.sum(),
                    mass[m][order]))
    return out
