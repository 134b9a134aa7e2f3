"""sRGB <-> CIE Lab conversions on tensors (D65 white, 2-degree observer).

Counterpart of ``ideepcolor_tpu/ops/colorspace.py`` with the same
conventions: rgb is float in [0, 1], channel-last ``(..., 3)``; L in
[0, 100], a/b roughly [-110, 110]; ``lab_to_rgb`` clips into [0, 1] and
``lab_to_rgb_u8`` truncates ``x255`` to uint8, as the reference does.

PyTorch has no ``cbrt``. ``_lab_f`` takes ``t.pow(1/3)`` only where
``t > _EPS > 0``, so it is defined there, but it can differ from
``jnp.cbrt`` by about 1 ulp: Lab from :func:`rgb_to_lab` agrees with the
JAX function to about 1e-4 absolute (L in [0, 100]).
"""

from __future__ import annotations

import torch

# sRGB -> XYZ (IEC 61966-2-1, the constants skimage uses).
RGB2XYZ = (
    (0.412456439089692, 0.357576077643909, 0.180437483266399),
    (0.212672851405623, 0.715152155287818, 0.072174993306560),
    (0.019333895582329, 0.119192025881303, 0.950304078536368),
)
# Its inverse as the JAX package's compose computes it (jnp.linalg.inv of
# the f32 matrix above; these are those f32 values). The Pallas kernel
# inlines the float64 inverse instead, which differs by about 1 ulp per
# entry -- enough to put the white point (L=100, ab=0) on the other side of
# the 255 boundary (G: 254 there, 255 here and in the JAX click). Mask and
# gray frames are mostly white, so the port follows the JAX main path.
XYZ2RGB = (
    (3.2404537200927734, -1.5371384620666504, -0.498531311750412),
    (-0.969265878200531, 1.8760108947753906, 0.041555989533662796),
    (0.05564342439174652, -0.20402590930461884, 1.0572251081466675),
)
WHITE = (0.95047, 1.0, 1.08883)

_EPS = 216.0 / 24389.0          # (6/29)^3
_KAPPA = 24389.0 / 27.0         # 29^3 / 3^3


def srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    srgb = srgb.to(torch.float32)
    return torch.where(srgb <= 0.04045, srgb / 12.92,
                       ((srgb + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(lin: torch.Tensor) -> torch.Tensor:
    lin = lin.to(torch.float32)
    safe = lin.clamp_min(0.0)
    return torch.where(lin <= 0.0031308, lin * 12.92,
                       1.055 * safe ** (1.0 / 2.4) - 0.055)


def _apply_3x3(m, v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([m[i][0] * x + m[i][1] * y + m[i][2] * z
                        for i in range(3)], dim=-1)


def rgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    return _apply_3x3(RGB2XYZ, srgb_to_linear(rgb))


def xyz_to_rgb(xyz: torch.Tensor) -> torch.Tensor:
    return linear_to_srgb(_apply_3x3(XYZ2RGB, xyz)).clamp(0.0, 1.0)


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > _EPS, t.pow(1.0 / 3.0), (_KAPPA * t + 16.0) / 116.0)


def _lab_finv(ft: torch.Tensor) -> torch.Tensor:
    return torch.where(ft > 6.0 / 29.0, ft * ft * ft,
                       (116.0 * ft - 16.0) / _KAPPA)


def xyz_to_lab(xyz: torch.Tensor) -> torch.Tensor:
    f = _lab_f(torch.stack([xyz[..., i] / WHITE[i] for i in range(3)], -1))
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def lab_to_xyz(lab: torch.Tensor) -> torch.Tensor:
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    return torch.stack([_lab_finv(f) * WHITE[i]
                        for i, f in enumerate((fx, fy, fz))], dim=-1)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB [0,1] (..., 3) -> Lab (..., 3)."""
    return xyz_to_lab(rgb_to_xyz(rgb))


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """Lab (..., 3) -> sRGB [0,1] (..., 3), clipped."""
    return xyz_to_rgb(lab_to_xyz(lab))


def requantized_ab(rgb_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (..., 3) -> (..., 2) ab of its own Lab, the /255
    dequantization first.

    Parity detail: the reference derives ``output_ab`` from the QUANTIZED
    uint8 output frame, not from the raw prediction."""
    return rgb_to_lab(rgb_u8.to(torch.float32) / 255.0)[..., 1:]


def lab_to_rgb_u8(lab: torch.Tensor) -> torch.Tensor:
    """Lab -> uint8 RGB: ``(clip(lab2rgb(lab), 0, 1) * 255)`` truncated, the
    reference's ``lab2rgb_transpose`` convention."""
    return (lab_to_rgb(lab) * 255.0).to(torch.uint8)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB [0,1] (..., 3) -> HSV (..., 3), as ``skimage.color.rgb2hsv``:
    the mean-saturation input of the global-statistics extraction.

    ``torch.remainder`` keeps the sign of the divisor, as Python's ``%`` on
    a negative ``(g - b) / c`` does (``fmod`` would not); a gray pixel has
    hue 0, a black one saturation 0; where two channels tie for the
    maximum, red is tested before green."""
    rgb = rgb.to(torch.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = rgb.max(dim=-1).values
    c = v - rgb.min(dim=-1).values
    safe_c = torch.where(c == 0, 1.0, c)
    h_r = torch.remainder((g - b) / safe_c, 6.0)
    h_g = (b - r) / safe_c + 2.0
    h_b = (r - g) / safe_c + 4.0
    h = torch.where(v == r, h_r, torch.where(v == g, h_g, h_b)) / 6.0
    h = torch.where(c == 0, 0.0, h)
    s = torch.where(v == 0, 0.0, c / torch.where(v == 0, 1.0, v))
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """HSV (..., 3) -> sRGB [0,1]. Inverse of :func:`rgb_to_hsv`."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def select(choices):
        out = choices[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([select([v, q, p, p, t, v]), select([t, v, v, q, p, p]),
                        select([p, p, t, v, v, q])], dim=-1)
