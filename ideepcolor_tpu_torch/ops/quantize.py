"""ab-color quantization: 313-bin soft encode/decode, annealed-mean decode.

Counterpart of ``ideepcolor_tpu/ops/quantize.py``: plain functions on
tensors. Each runs on the device of the tensor it is given; the default bin
table is made there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.color_bins import get_bins


def _centers(centers, like: torch.Tensor) -> torch.Tensor:
    if centers is None:
        centers = get_bins().pts_in_hull
    return torch.as_tensor(centers, device=like.device).to(torch.float32)


def soft_encode(ab: torch.Tensor, centers=None, nn: int = 1,
                sigma: float = 5.0) -> torch.Tensor:
    """Soft-encode ab values over the quantized gamut.

    ab: (..., 2) -> (..., K) soft one-hot: the ``nn`` nearest bins, weighted
    exp(-d^2 / 2 sigma^2) and normalized over those neighbors. With nn=1 it
    is the hard one-hot of the nearest bin.
    """
    centers = _centers(centers, ab)
    K = centers.shape[0]
    flat = ab.reshape(-1, 2).to(torch.float32)
    d2 = ((flat ** 2).sum(1, keepdim=True) - 2.0 * (flat @ centers.T)
          + (centers ** 2).sum(1)[None, :])
    if nn == 1:
        enc = torch.nn.functional.one_hot(d2.argmin(1), K).to(torch.float32)
    else:
        neg_d2, inds = torch.topk(-d2, nn, dim=1)
        # Subtract the max before the exp (it cancels in the normalization):
        # without it, points far from the hull underflow every f32 exp to 0
        # and normalize to NaN.
        neg_d2 = neg_d2 - neg_d2[:, :1]
        wts = torch.exp(neg_d2 / (2.0 * sigma ** 2))
        wts = wts / wts.sum(1, keepdim=True)
        enc = torch.zeros((flat.shape[0], K), dtype=torch.float32,
                          device=ab.device).scatter_(1, inds, wts)
    return enc.reshape(ab.shape[:-1] + (K,))


def decode(enc: torch.Tensor, centers=None) -> torch.Tensor:
    """(..., K) encoding -> (..., 2) ab by dotting with the bin centers."""
    return enc.to(torch.float32) @ _centers(centers, enc)


def annealed_mean(logits: torch.Tensor, T: float, centers=None,
                  axis: int = -1) -> torch.Tensor:
    """Temperature-sharpened softmax expectation over the ab bins: the Caffe
    dist head's Scale(T) -> Softmax -> 1x1 conv with the bin centers as
    weights (T=2.6 for the point estimate, 0.2 for the suggestion
    distribution)."""
    p = torch.softmax(logits.to(torch.float32) * T, dim=axis)
    return (p.movedim(axis, -1) @ _centers(centers, logits)).movedim(-1, axis)


def scatter_to_grid(dist313: torch.Tensor, in_hull,
                    grid_hw: tuple[int, int] = (23, 23)) -> torch.Tensor:
    """Scatter a (313, ...) in-gamut distribution into the full grid,
    ``dist_ab_full[in_hull] = dist_ab``, returned as (A, B, ...)."""
    full = torch.zeros((grid_hw[0] * grid_hw[1],) + dist313.shape[1:],
                       dtype=dist313.dtype, device=dist313.device)
    full[torch.as_tensor(in_hull, device=dist313.device).to(torch.bool)] = \
        dist313
    return full.reshape(tuple(grid_hw) + dist313.shape[1:])


def entropy(dist: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """sum p log p over the bin axis. The reference omits the minus sign and
    negates at plot time; its convention is kept."""
    return (dist * torch.log(dist)).sum(dim=axis)


def make_pts_grid(step: int = 10, lim: int = 110) -> np.ndarray:
    """Full 23x23 ab grid in np.meshgrid ordering (b slow, a fast), the
    SIGGRAPH dist head's bin order."""
    g = np.array(np.meshgrid(np.arange(-lim, lim + step, step),
                             np.arange(-lim, lim + step, step)))
    return g.reshape((2, -1)).T.astype(np.int64)
