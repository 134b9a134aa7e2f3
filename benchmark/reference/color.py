"""sRGB <-> CIE Lab (D65, 2-degree observer) in float32 torch, and the
uint8 frame compose: clip, then truncate ``x255``, as the reference
application's ``lab2rgb_transpose`` does.

The XYZ -> RGB matrix is the float32 inverse of the sRGB -> XYZ one (the
values below), the compose that both the reference application's GUI and
the program follow; the white point L=100, ab=0 lands on 255 in G with it.
"""

from __future__ import annotations

import torch

RGB2XYZ = (
    (0.412456439089692, 0.357576077643909, 0.180437483266399),
    (0.212672851405623, 0.715152155287818, 0.072174993306560),
    (0.019333895582329, 0.119192025881303, 0.950304078536368),
)
XYZ2RGB = (
    (3.2404537200927734, -1.5371384620666504, -0.498531311750412),
    (-0.969265878200531, 1.8760108947753906, 0.041555989533662796),
    (0.05564342439174652, -0.20402590930461884, 1.0572251081466675),
)
WHITE = (0.95047, 1.0, 1.08883)
EPS = 216.0 / 24389.0
KAPPA = 24389.0 / 27.0


def srgb_to_linear(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.float32)
    return torch.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(lin: torch.Tensor) -> torch.Tensor:
    safe = lin.clamp_min(0.0)
    return torch.where(lin <= 0.0031308, lin * 12.92,
                       1.055 * safe ** (1.0 / 2.4) - 0.055)


def _mat(m, x, y, z):
    return [m[i][0] * x + m[i][1] * y + m[i][2] * z for i in range(3)]


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) float RGB in [0, 1] -> (..., 3) Lab."""
    lin = srgb_to_linear(rgb)
    xyz = _mat(RGB2XYZ, lin[..., 0], lin[..., 1], lin[..., 2])
    f = [torch.where(t / w > EPS, (t / w).pow(1.0 / 3.0),
                     (KAPPA * (t / w) + 16.0) / 116.0)
         for t, w in zip(xyz, WHITE)]
    return torch.stack([116.0 * f[1] - 16.0, 500.0 * (f[0] - f[1]),
                        200.0 * (f[1] - f[2])], dim=-1)


def _finv(ft: torch.Tensor) -> torch.Tensor:
    return torch.where(ft > 6.0 / 29.0, ft * ft * ft,
                       (116.0 * ft - 16.0) / KAPPA)


def lab_to_rgb_u8(l: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """(..., H, W) float L, a, b -> (..., H, W, 3) uint8, clipped and
    truncated."""
    l, a, b = (t.to(torch.float32) for t in (l, a, b))
    fy = (l + 16.0) / 116.0
    x = _finv(fy + a / 500.0) * WHITE[0]
    y = _finv(fy) * WHITE[1]
    z = _finv(fy - b / 200.0) * WHITE[2]
    rgb = [linear_to_srgb(c) for c in _mat(XYZ2RGB, x, y, z)]
    return torch.stack([(c.clamp(0.0, 1.0) * 255.0).to(torch.int32)
                        .to(torch.uint8) for c in rgb], dim=-1)


def frame_ab(rgb_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 frame -> (..., 2) ab of its own Lab: the reference
    application's ``output_ab``, taken from the quantized frame."""
    return rgb_to_lab(rgb_u8.to(torch.float32) / 255.0)[..., 1:]
