"""The net-size image: ``cv2.resize(im, (w, h))`` with its default
INTER_LINEAR on uint8, in cv2's own fixed-point arithmetic (11-bit weights,
an int32 horizontal pass, a truncating vertical pass; an exact 2x shrink
takes cv2's 2x2 box average), on torch integer tensors."""

from __future__ import annotations

import numpy as np
import torch

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _taps(n_in: int, n_out: int, clamp_weight: bool):
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


def resize_u8(im: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H, W, C) uint8 -> (h, w, C) uint8."""
    H, W = im.shape[:2]
    x = im.to(torch.int32)
    if (H, W) == (2 * h, 2 * w):
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        return ((s + 2) >> 2).to(torch.uint8)
    tap = lambda a: torch.as_tensor(a, device=im.device)  # noqa: E731
    c0, c1, a0, a1 = map(tap, _taps(W, w, clamp_weight=True))
    r0, r1, b0, b1 = map(tap, _taps(H, h, clamp_weight=False))
    rows = x[:, c0] * a0[None, :, None] + x[:, c1] * a1[None, :, None]
    out = (((b0[:, None, None] * (rows[r0] >> 4)) >> 16)
           + ((b1[:, None, None] * (rows[r1] >> 4)) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)
