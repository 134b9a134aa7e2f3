"""Image resampling for the port's main path.

Counterpart of the pieces of ``ideepcolor_tpu/ops/resize.py`` the click and
the full-res getters use:

* ``scipy.ndimage.zoom`` semantics (align-corners; order 1 for the ab
  upsample, order 0 for masks) as host-built interpolation matrices
  (:func:`linear_resize_matrix_np`, :func:`nearest_resize_matrix_np`)
  applied on the device by two matrix products
  (:func:`zoom_with_matrices`, a library ``matmul`` as in the JAX package);
* the GUI's window resize, ``cv2.INTER_CUBIC`` as a matrix
  (:func:`cubic_resize_matrix_np`) for the same two products;
* the dist head's integer-factor nearest upsample
  (:func:`upsample_nearest`);
* the net-size image resize, :func:`resize_u8_half_pixel`: ``cv2.resize``
  with ``INTER_LINEAR`` (half-pixel centres, no antialias), written in
  torch integer arithmetic so the port needs no cv2 or PIL.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def linear_resize_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) align-corners bilinear interpolation matrix."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return m
    c = np.arange(n_out) * ((n_in - 1) / (n_out - 1))
    i0 = np.clip(np.floor(c).astype(np.int32), 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    w = (c - i0).astype(np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), 1.0 - w)
    np.add.at(m, (rows, i1), w)
    return m


def nearest_resize_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) align-corners NEAREST matrix (scipy zoom order=0:
    round half up)."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return m
    c = np.arange(n_out) * ((n_in - 1) / (n_out - 1))
    idx = np.clip(np.floor(c + 0.5).astype(np.int32), 0, n_in - 1)
    m[np.arange(n_out), idx] = 1.0
    return m


def cubic_resize_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) ``cv2.INTER_CUBIC`` interpolation matrix: half-pixel
    centers, Catmull-Rom-style kernel with A=-0.75, replicated borders.

    Bicubic resampling is separable and linear, so
    :func:`zoom_with_matrices` serves it: the GUI's window-frame resize is
    cv2's by swapping the matrices."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_in == 1:
        m[:, 0] = 1.0
        return m
    A = -0.75
    c = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    sx = np.floor(c).astype(np.int64)
    t = c - sx
    # OpenCV's interpolateCubic coefficient polynomial (A = -0.75)
    w0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w1 = ((A + 2) * t - (A + 3)) * t * t + 1
    w2 = ((A + 2) * (1 - t) - (A + 3)) * (1 - t) * (1 - t) + 1
    w3 = 1.0 - w0 - w1 - w2
    rows = np.arange(n_out)
    for k, w in ((-1, w0), (0, w1), (1, w2), (2, w3)):
        idx = np.clip(sx + k, 0, n_in - 1)
        np.add.at(m, (rows, idx), w.astype(np.float32))
    return m


def upsample_nearest(x: torch.Tensor, factor: int, h_axis: int = -3,
                     w_axis: int = -2) -> torch.Tensor:
    """Integer-factor nearest upsample (``nn.Upsample(mode='nearest')``),
    the SIGGRAPH dist head's x4 distribution upsample. The default axes
    are the channel-last layout's."""
    x = x.repeat_interleave(factor, dim=h_axis % x.ndim)
    return x.repeat_interleave(factor, dim=w_axis % x.ndim)


def zoom_with_matrices(x: torch.Tensor, rh: torch.Tensor,
                       rw: torch.Tensor) -> torch.Tensor:
    """(..., h, w, C) resize with interpolation matrices rh (H, h) and
    rw (W, w): contract h, then w, in f32 (TF32 is off in parity mode, see
    ``ideepcolor_tpu_torch.device``)."""
    x = x.to(torch.float32)
    y = torch.einsum("Hh,...hwc->...Hwc", rh, x)
    return torch.einsum("Ww,...Hwc->...HWc", rw, y)


# cv2's INTER_LINEAR on uint8 works in fixed point: 11-bit weights
# (INTER_RESIZE_COEF_BITS), a horizontal pass into int32 rows, then a
# vertical pass with shifts that truncate. Reproducing that integer
# arithmetic, rather than f32 bilinear rounded to uint8 (1 LSB off on a
# large share of the pixels), makes the net-size image the one cv2 makes.
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _cv2_linear_taps(n_in: int, n_out: int, clamp_weight: bool):
    """cv2's per-output source index, next index and fixed-point weights.

    The coordinate is computed in float32 as cv2 does. Columns
    (``clamp_weight``) zero the fraction where the source index leaves the
    image; rows keep it and only clamp the two indices."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_weight:
        out = (s < 0) | (s >= n_in - 1)
        f[out] = 0.0
        s = np.clip(s, 0, n_in - 1)
    i0 = np.clip(s, 0, n_in - 1)
    i1 = np.clip(s + 1, 0, n_in - 1)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE))
    w1 = np.rint(f * np.float32(_COEF_SCALE))
    return i0, i1, w0.astype(np.int32), w1.astype(np.int32)


def resize_u8_half_pixel(im: torch.Tensor, out_hw: tuple[int, int]
                         ) -> torch.Tensor:
    """(H, W, C) image -> out_hw, half-pixel bilinear without antialias:
    ``cv2.resize(im, (w, h))`` with its default ``INTER_LINEAR``.

    uint8 input follows cv2's fixed-point arithmetic (and its switch to a
    2x2 box average for an exact 2x shrink), so no cv2 or PIL is needed;
    float input is f32 bilinear."""
    H, W = im.shape[:2]
    h, w = out_hw
    if im.dtype != torch.uint8:
        x = im.to(torch.float32).permute(2, 0, 1)[None]
        return F.interpolate(x, size=(h, w), mode="bilinear",
                             align_corners=False)[0].permute(1, 2, 0) \
            .contiguous()
    x = im.to(torch.int32)
    if (H, W) == (2 * h, 2 * w):                 # cv2 uses INTER_AREA here
        s = (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2])
        return ((s + 2) >> 2).to(torch.uint8)
    dev = im.device
    tap = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    c0, c1, a0, a1 = map(tap, _cv2_linear_taps(W, w, clamp_weight=True))
    r0, r1, b0, b1 = map(tap, _cv2_linear_taps(H, h, clamp_weight=False))
    rows = x[:, c0] * a0[None, :, None] + x[:, c1] * a1[None, :, None]
    out = (((b0[:, None, None] * (rows[r0] >> 4)) >> 16)
           + ((b1[:, None, None] * (rows[r1] >> 4)) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)
