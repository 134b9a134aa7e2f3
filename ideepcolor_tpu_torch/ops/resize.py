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
* the Caffe dist head's fixed x2 bilinear upsampler
  (:func:`bilinear_up2_fixed`, a depthwise transposed conv);
* the net-size image resize, :func:`resize_u8_half_pixel`: ``cv2.resize``
  with ``INTER_LINEAR`` (half-pixel centres, no antialias), written in
  torch integer arithmetic so the port needs no cv2 or PIL;
* the GUI's image resizes, :func:`resize_u8_cubic`: ``cv2.resize`` with
  ``INTER_CUBIC`` on uint8, in cv2's own fixed-point arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def linear_resize_matrix_np(n_in: int, n_out: int,
                            n_rows: int | None = None) -> np.ndarray:
    """(n_out, n_in) align-corners bilinear interpolation matrix; with
    ``n_rows``, (n_rows, n_in) whose rows past ``n_out`` are zero: the
    matrices of the bucketed full-res programs, which serve every output
    size of a bucket."""
    m = np.zeros((n_rows or n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        m[:n_out, 0] = 1.0
        return m
    c = np.arange(n_out) * ((n_in - 1) / (n_out - 1))
    i0 = np.clip(np.floor(c).astype(np.int32), 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    w = (c - i0).astype(np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), 1.0 - w)
    np.add.at(m, (rows, i1), w)
    return m


def nearest_resize_matrix_np(n_in: int, n_out: int,
                             n_rows: int | None = None) -> np.ndarray:
    """(n_out, n_in) align-corners NEAREST matrix (scipy zoom order=0:
    round half up); padded with zero rows to ``n_rows`` as
    :func:`linear_resize_matrix_np`."""
    m = np.zeros((n_rows or n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        m[:n_out, 0] = 1.0
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


# Fixed 2x bilinear upsampling kernel the reference injects into the Caffe
# '*_us' grouped deconvolutions. Its last row and column are zero.
CAFFE_US_KERNEL = (
    (0.25, 0.5, 0.25, 0.0),
    (0.5, 1.0, 0.5, 0.0),
    (0.25, 0.5, 0.25, 0.0),
    (0.0, 0.0, 0.0, 0.0),
)


_US_KERNELS: dict = {}


def _us_kernel(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``CAFFE_US_KERNEL`` on ``device``, made once per device and type: a
    host-to-device copy at every call would be illegal while a click is
    captured into a CUDA graph (the warm-up run before a capture makes it)."""
    k = _US_KERNELS.get((device, dtype))
    if k is None:
        k = _US_KERNELS[device, dtype] = torch.tensor(
            CAFFE_US_KERNEL, dtype=dtype, device=device)
    return k


def bilinear_up2_fixed(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 2x transposed conv with the fixed reference kernel: Caffe's
    ``Deconvolution(kernel=4, stride=2, pad=1, group=C)`` with
    ``CAFFE_US_KERNEL`` as every channel's weight. (N, C, H, W) ->
    (N, C, 2H, 2W), in the type of ``x``.

    The kernel goes to ``conv_transpose2d`` as it is written above. The JAX
    package computes the same function as a regular conv over the dilated
    input, which takes the kernel flipped (zero row and column leading)."""
    c = x.shape[1]
    k = _us_kernel(x.device, x.dtype)
    return F.conv_transpose2d(x, k.expand(c, 1, 4, 4), stride=2, padding=1,
                              groups=c)


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


# cv2's INTER_CUBIC on uint8 (OpenCV's resize, not the IPP one an IPP build
# of cv2 takes by default: IPP computes in float and differs by 1 LSB on a
# few percent of the pixels). The cubic coefficients at A = -0.75 are
# computed in float32 and rounded to 11-bit shorts; the horizontal pass sums
# four taps into int32 rows (borders replicated). The vertical pass is
# vectorized: the first multiple of 8 values of every output row are
# computed in float32 from the rows and the shorts times 2**-22, product by
# product from the last tap to the first (no fused multiply-add), and
# rounded half to even; the row's remaining values take the scalar integer
# form, rounded by + 2**21 >> 22. Both saturate to uint8.
_CUBIC_VEC = 8


def _cv2_cubic_taps(n_in: int, n_out: int):
    """cv2's four source indices (clamped) and 11-bit cubic weights per
    output index, (n_out, 4) each."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f)
    x = f - s
    one = np.float32(1.0)
    A = np.float32(-0.75)
    c0 = ((A * (x + one) - np.float32(5) * A) * (x + one)
          + np.float32(8) * A) * (x + one) - np.float32(4) * A
    c1 = ((A + np.float32(2)) * x - (A + np.float32(3))) * x * x + one
    c2 = ((A + np.float32(2)) * (one - x) - (A + np.float32(3))) \
        * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    w = np.rint(np.stack([c0, c1, c2, c3], 1) * np.float32(_COEF_SCALE))
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None], 0,
                  n_in - 1)
    return idx, w.astype(np.int32)


def resize_u8_cubic(im: torch.Tensor, out_hw: tuple[int, int]
                    ) -> torch.Tensor:
    """(H, W, C) uint8 -> (h, w, C) uint8, as ``cv2.resize(im, (w, h),
    interpolation=cv2.INTER_CUBIC)`` computes it without IPP, bit for bit
    (see the comment above). Runs on the device of ``im``."""
    if im.dtype != torch.uint8 or im.ndim != 3:
        raise ValueError(f"expected (H,W,C) uint8, got {tuple(im.shape)} "
                         f"{im.dtype}")
    H, W, C = im.shape
    h, w = out_hw
    dev = im.device
    xi, xw = (torch.as_tensor(a, device=dev) for a in _cv2_cubic_taps(W, w))
    yi, yw = _cv2_cubic_taps(H, h)
    x = im.to(torch.int32)
    rows = sum(x[:, xi[:, k]] * xw[None, :, k, None] for k in range(4))
    rows = rows.reshape(H, w * C)
    n_vec = (w * C) // _CUBIC_VEC * _CUBIC_VEC
    out = torch.empty((h, w * C), dtype=torch.uint8, device=dev)
    ry = [torch.as_tensor(yi[:, k], device=dev) for k in range(4)]
    if n_vec:
        r = rows[:, :n_vec].to(torch.float32)
        beta = torch.as_tensor(yw.astype(np.float32)
                               * np.float32(1.0 / _COEF_SCALE ** 2),
                               device=dev)
        t = r[ry[3]] * beta[:, 3, None]
        for k in (2, 1, 0):
            t = r[ry[k]] * beta[:, k, None] + t
        out[:, :n_vec] = torch.round(t).clamp(0, 255).to(torch.uint8)
    if n_vec < w * C:
        r = rows[:, n_vec:].to(torch.int64)
        beta = torch.as_tensor(yw.astype(np.int64), device=dev)
        acc = sum(r[ry[k]] * beta[:, k, None] for k in range(4))
        out[:, n_vec:] = ((acc + (1 << (2 * _COEF_BITS - 1)))
                          >> (2 * _COEF_BITS)).clamp(0, 255).to(torch.uint8)
    return out.reshape(h, w, C)


# PIL's ``Image.resize(size, Image.BILINEAR)`` on uint8 (Pillow's
# ``Resample.c``): a triangle filter whose support widens by the reduction
# factor (it antialiases when shrinking), coefficients normalized per output
# pixel in float64 and then rounded to 22-bit fixed point, a horizontal pass
# and then a vertical one, each rounding to uint8; a side that keeps its size
# is not resampled. The training and eval loaders of the JAX package resize
# with PIL; the card's machine has no PIL.
_PIL_BITS = 22


def pil_bilinear_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 matrix of PIL's fixed-point BILINEAR
    coefficients (integers, each row summing to about 2**22)."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = filterscale                      # the triangle's support is 1
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), n_in)
    x = xmin[:, None] + np.arange(ksize)[None]
    valid = x < xmax[:, None]
    t = np.abs(((x - center[:, None]) + 0.5) * (1.0 / filterscale))
    w = np.where(valid & (t < 1.0), 1.0 - t, 0.0)
    ww = w.sum(1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = np.trunc(w * (1 << _PIL_BITS) + np.where(w < 0, -0.5, 0.5))
    m = np.zeros((n_out, n_in))
    rows = np.broadcast_to(np.arange(n_out)[:, None], x.shape)
    m[rows[valid], x[valid]] = fixed[valid]
    return m


def _pil_pass(im: np.ndarray, m: np.ndarray, axis: int) -> np.ndarray:
    # integer-valued float64: every product and partial sum stays below
    # 2**53, so the product is exact in any order
    acc = np.moveaxis(np.tensordot(im.astype(np.float64), m, ([axis], [1])),
                      -1, axis)
    return np.clip(np.floor((acc + (1 << (_PIL_BITS - 1)))
                            / (1 << _PIL_BITS)), 0, 255).astype(np.uint8)


def resize_u8_pil_bilinear(im: np.ndarray, out_hw: tuple[int, int]
                           ) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8, as PIL's
    ``Image.fromarray(im).resize((w, h), Image.BILINEAR)``."""
    im = np.asarray(im, np.uint8)
    h, w = out_hw
    if im.shape[1] != w:
        im = _pil_pass(im, pil_bilinear_matrix_np(im.shape[1], w), 1)
    if im.shape[0] != h:
        im = _pil_pass(im, pil_bilinear_matrix_np(im.shape[0], h), 0)
    return np.array(im, copy=True)
