"""Kernel K5: the color-suggestion chain after its random draws, in one
launch (``csrc/kmeans_kernel.cu``).

Counterpart of ``ideepcolor_tpu/ops/kmeans.py`` ``ab_recommendations``
past its two draws: the histogram of the N sampler draws under the pixel's
pdf, k-means++ seeding of the ``RESTARTS`` restarts, the Lloyd steps, the
restart of lowest inertia and its clusters sorted by occupancy. The plain
version is the port's chain, ``ops.kmeans.bins_from_uniform`` then
``ops.kmeans.kmeans_from_uniform``, which the kernel follows bit for bit
but where float32 rounding decides a choice either way (a seeding draw at
the boundary of two points, two restarts' inertias within rounding): see
the source.

:func:`engages` is the rule by which ``ops.kmeans.ab_recommendations``
takes the kernel: a pdf and point table of one length on a CUDA device,
which one block's shared memory holds, and a palette that one warp sorts;
the chain casts both to float32 first, as the plain chain does.
:func:`suggest` launches the kernel on float32 CUDA tensors or raises; it
never falls back. It takes the pdf's ``torch.cumsum`` from PyTorch, so the
sampler's bins are those of ``torch.searchsorted`` on the chain's own cmf.
"""

from __future__ import annotations

import ctypes

import torch

from .build import Kernel

KERNEL = Kernel(
    name="kmeans",
    source="kmeans_kernel.cu",
    symbol="ideepcolor_kmeans",
    argtypes=[ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    replaces="ideepcolor_tpu/ops/kmeans.py:108",
)

# the kernel's restarts (ops.kmeans.RESTARTS), its largest palette (one
# warp sorts it) and its largest table (shared memory of one block)
RESTARTS = 4
MAX_K = 32
MAX_POINTS = 768
_INT32 = 2 ** 31


def engages(pdf, points, K: int) -> bool:
    """Whether a suggestion on ``pdf`` (Q,) over ``points`` (P, 2) with a
    K-color palette runs on K5: pdf and points on one CUDA device, P = Q at
    most ``MAX_POINTS``, 1 <= K <= ``MAX_K``. Their dtype does not count:
    the chain takes both as float32."""
    return (pdf.device.type == "cuda" and points.device == pdf.device
            and pdf.dim() == 1
            and points.dim() == 2 and points.shape[1] == 2
            and 1 <= points.shape[0] == pdf.shape[0] <= MAX_POINTS
            and 1 <= K <= MAX_K)


def suggest(pdf: torch.Tensor, points: torch.Tensor, u_bins: torch.Tensor,
            u_seeds: torch.Tensor, iters: int = 30,
            return_counts: bool = False):
    """One launch: the (K, 3) palette, rows (a, b, confidence) sorted by
    occupancy, descending, from the pdf (Q,), the bins' ab centers (Q, 2),
    the sampler's uniform numbers (N,) and the seeding's (RESTARTS, K).
    With ``return_counts`` also the (Q,) int32 histogram of the draws."""
    K = u_seeds.shape[-1] if u_seeds.dim() == 2 else 0
    if not (engages(pdf, points, K) and pdf.dtype == torch.float32
            and points.dtype == torch.float32):
        raise ValueError(
            f"kmeans: pdf {tuple(pdf.shape)} {pdf.dtype} on {pdf.device}, "
            f"points {tuple(points.shape)} {points.dtype} on "
            f"{points.device}, K={K}; want CUDA float32, P = Q <= "
            f"{MAX_POINTS}, 1 <= K <= {MAX_K}")
    if (u_seeds.shape[0] != RESTARTS or u_bins.dim() != 1
            or u_bins.numel() >= _INT32 or iters < 0
            or any(t.device != pdf.device or t.dtype != torch.float32
                   for t in (u_bins, u_seeds))):
        raise ValueError(
            f"kmeans: draws {tuple(u_bins.shape)} and "
            f"{tuple(u_seeds.shape)}, iters {iters}; want float32 (N,) and "
            f"({RESTARTS}, K) on {pdf.device}, N < 2^31, iters >= 0")
    KERNEL.load()                       # no library -> raise, allocate nothing
    cum = torch.cumsum(pdf, 0)
    points, u_bins, u_seeds = (t.contiguous()
                               for t in (points, u_bins, u_seeds))
    out = torch.empty((K, 3), dtype=torch.float32, device=pdf.device)
    counts = (torch.empty(pdf.shape[0], dtype=torch.int32, device=pdf.device)
              if return_counts else None)
    KERNEL.launch(cum.data_ptr(), pdf.shape[0], u_bins.data_ptr(),
                  u_bins.numel(), points.data_ptr(), u_seeds.data_ptr(), K,
                  int(iters), out.data_ptr(),
                  counts.data_ptr() if counts is not None else None,
                  torch.cuda.current_stream(pdf.device).cuda_stream)
    return (out, counts) if return_counts else out
