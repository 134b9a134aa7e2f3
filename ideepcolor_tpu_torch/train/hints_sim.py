"""Simulated user hints for training and evaluation, on the batch's device.

Counterpart of ``ideepcolor_tpu/train/hints_sim.py``: the number of revealed
points is geometric, their centers a center-weighted 2-D Gaussian, their
patch half-widths uniform in 0..4, and each patch carries the mean ground
truth ab of its in-image area; with probability ``p_full`` a sample reveals
its whole ground truth instead. A fixed table of ``MAX_POINTS`` slots with a
live prefix keeps every shape static.

Random numbers come from a ``torch.Generator`` on the tensors' device, where
the JAX functions take a key. Each random function has a deterministic core
that takes the draws (:func:`hints_from_draws`,
:func:`reveal_fixed_from_normals`, :func:`global_hints_from_keep`), so the
tests feed it the numbers JAX draws.

Layout is NCHW: ground truth ab (N,2,H,W) in, hint ab (N,2,H,W) and mask
(N,1,H,W) out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.quantize import soft_encode

MAX_POINTS = 32          # training slots; the clicks' table is MAX_HINTS = 256
PMAX = 4                 # largest half-width drawn: the patch-mean window


def locations_from_normals(normals: torch.Tensor, h: int, w: int
                           ) -> torch.Tensor:
    """(N,P,2) standard normals -> (N,P,2) int64 (y, x) centers:
    ``clip(z * size / 4 + size / 2, 0, size - 1)`` truncated, in f32."""
    normals = normals.to(torch.float32)
    y = (normals[..., 0] * (h / 4) + h / 2).clamp(0, h - 1)
    x = (normals[..., 1] * (w / 4) + w / 2).clamp(0, w - 1)
    return torch.stack([y, x], -1).to(torch.int64)


def reveal_batch(gt_ab: torch.Tensor, loc: torch.Tensor, half: torch.Tensor,
                 alive: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rasterize the live slots' mean-ab patches. gt_ab (N,2,H,W); loc
    (N,P,2) centers; half (N,P) half-widths in [0, PMAX]; alive (N,P) bool.
    Where patches overlap the last live slot wins. A slot's value is the
    mean of its patch's in-image pixels, read through a fixed
    (2 PMAX + 1)^2 window around its center."""
    n, _, h, w = gt_ab.shape
    dev = gt_ab.device
    y, x = loc[..., 0].to(torch.int64), loc[..., 1].to(torch.int64)
    half = half.to(torch.int64)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    in_y = ((ys >= (y - half)[..., None]) & (ys <= (y + half)[..., None])
            & alive[..., None])
    in_x = (xs >= (x - half)[..., None]) & (xs <= (x + half)[..., None])
    slot = torch.arange(1, loc.shape[1] + 1, dtype=torch.uint8, device=dev)
    inside = in_y[..., :, None] & in_x[..., None, :]          # (N,P,H,W)
    last = torch.where(inside, slot[:, None, None],
                       torch.zeros((), dtype=torch.uint8, device=dev)
                       ).amax(1)                  # (N,H,W), 0 = uncovered

    d = torch.arange(-PMAX, PMAX + 1, device=dev)
    gtp = F.pad(gt_ab.to(torch.float32), (PMAX,) * 4)
    rows = y[..., None] + d + PMAX                             # (N,P,9)
    cols = x[..., None] + d + PMAX
    nidx = torch.arange(n, device=dev)[:, None, None, None]
    win = gtp[nidx, :, rows[..., :, None], cols[..., None, :]]  # (N,P,9,9,2)
    near = d.abs() <= half[..., None]
    ok_r = near & (y[..., None] + d >= 0) & (y[..., None] + d <= h - 1)
    ok_c = near & (x[..., None] + d >= 0) & (x[..., None] + d <= w - 1)
    wgt = (ok_r[..., :, None] & ok_c[..., None, :]).to(torch.float32)
    vals = ((win * wgt[..., None]).sum((2, 3))
            / wgt.sum((2, 3)).clamp_min(1.0)[..., None])       # (N,P,2)

    vals0 = torch.cat([vals.new_zeros(n, 1, 2), vals], 1).transpose(1, 2)
    idx = last.to(torch.int64).view(n, 1, h * w).expand(n, 2, h * w)
    ab = vals0.gather(2, idx).view(n, 2, h, w)
    return ab, (last > 0).to(torch.float32)[:, None]


def hints_from_draws(gt_ab: torch.Tensor, coins: torch.Tensor,
                     normals: torch.Tensor, half: torch.Tensor,
                     full: torch.Tensor | None, p_keep: float = 1.0 / 8.0):
    """The deterministic core of :func:`sample_hints`. coins (N,P) uniform:
    slot i is alive iff coins[:, :i+1] all exceed ``p_keep`` (so P(0 hints)
    = p_keep); normals (N,P,2); half (N,P) in 0..4; full (N,) bool, the
    full-reveal flags (None: no full reveal)."""
    n, _, h, w = gt_ab.shape
    alive = torch.cumprod((coins > p_keep).to(torch.int32), 1).to(torch.bool)
    hint_ab, hint_mask = reveal_batch(
        gt_ab, locations_from_normals(normals, h, w), half, alive)
    if full is None:
        return hint_ab, hint_mask
    f = full.to(torch.float32).view(n, 1, 1, 1)
    return hint_ab * (1.0 - f) + gt_ab * f, torch.maximum(hint_mask, f)


def sample_hints(gt_ab: torch.Tensor, generator: torch.Generator,
                 p_keep: float = 1.0 / 8.0, p_full: float = 0.01):
    """gt_ab (N,2,H,W) -> (hint_ab (N,2,H,W), hint_mask (N,1,H,W)): a
    geometric(p_keep) number of points (at most MAX_POINTS), each a
    (2p+1)^2 patch, p uniform in 0..4, at a clipped Gaussian center, with
    the patch's mean ground truth; with probability ``p_full`` (the
    published recipe's 1%) the whole ground truth instead. ``generator``
    lies on gt_ab's device."""
    n = gt_ab.shape[0]
    kw = dict(generator=generator, device=gt_ab.device)
    coins = torch.rand((n, MAX_POINTS), **kw)
    normals = torch.randn((n, MAX_POINTS, 2), **kw)
    half = torch.randint(0, PMAX + 1, (n, MAX_POINTS), **kw)
    full = torch.rand((n,), **kw) < p_full if p_full > 0.0 else None
    return hints_from_draws(gt_ab, coins, normals, half, full, p_keep)


def reveal_fixed_from_normals(gt_ab: torch.Tensor, normals: torch.Tensor,
                              count, half: int = 2):
    """The deterministic core of :func:`reveal_hints_fixed`: the first
    ``count`` slots live, every patch (2 half + 1)^2, centers from
    ``normals`` (N,P,2)."""
    if not 0 <= half <= PMAX:
        # the patch mean reads a fixed 9x9 window: a larger patch would be
        # revealed with the mean of its central 9x9 only
        raise ValueError(f"half must be in [0, {PMAX}], got {half}")
    n, _, h, w = gt_ab.shape
    dev = gt_ab.device
    halves = torch.full((n, MAX_POINTS), half, dtype=torch.int64, device=dev)
    alive = (torch.arange(MAX_POINTS, device=dev)[None]
             < torch.as_tensor(count, device=dev)).expand(n, MAX_POINTS)
    return reveal_batch(gt_ab, locations_from_normals(normals, h, w), halves,
                        alive)


def draw_normals(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """(n, MAX_POINTS, 2) location normals from ``generator``."""
    return torch.randn((n, MAX_POINTS, 2), generator=generator, device=device)


def reveal_hints_fixed(gt_ab: torch.Tensor, generator: torch.Generator,
                       count, half: int = 2):
    """Exactly ``count`` (<= MAX_POINTS) revealed patches per image, each
    (2 half + 1)^2 with the mean ground truth of its in-image area, at the
    training sampler's Gaussian centers: the evaluation protocol of the
    PSNR-vs-hints sweep."""
    return reveal_fixed_from_normals(
        gt_ab, draw_normals(gt_ab.shape[0], generator, gt_ab.device), count,
        half)


def global_hints_from_keep(gt_ab: torch.Tensor, keep: torch.Tensor
                           ) -> torch.Tensor:
    """The deterministic core of :func:`sample_global_hints`: keep (N,)
    bool, whether each example's histogram is revealed."""
    n = gt_ab.shape[0]
    ab_rs = F.avg_pool2d(gt_ab.to(torch.float32), 4)
    hist = soft_encode(ab_rs.movedim(1, -1), nn=1).mean((1, 2))  # (N,313)
    k = keep.to(torch.float32).view(n, 1)
    return torch.cat([hist * k, k], 1)


def sample_global_hints(gt_ab: torch.Tensor, generator: torch.Generator,
                        keep_ratio: float = 0.5) -> torch.Tensor:
    """Training-time global-histogram conditioning with dropout: gt_ab
    (N,2,H,W) -> (N,314), the 313-bin histogram of the 4x4-pooled ab and a
    keep flag; with probability 1 - keep_ratio both are zero."""
    keep = torch.rand((gt_ab.shape[0],), generator=generator,
                      device=gt_ab.device) < keep_ratio
    return global_hints_from_keep(gt_ab, keep)
