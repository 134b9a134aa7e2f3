"""Host-facing gamut helpers: 1-d color conversions, gamut snap, ab grid.

Counterpart of ``ideepcolor_tpu/data/lab_gamut.py`` (``snap_ab``,
``rgb2lab_1d``, ``lab2rgb_1d``, ``abGrid``), numpy in and out, backed by the
device ops of :mod:`ideepcolor_tpu_torch.ops.gamut`. Each runs on the card
unless the caller passes ``device="cpu"``. No Qt: ``qcolor2lab_1d`` takes
any object with ``red()``, ``green()`` and ``blue()``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import colorspace as _cs
from ..ops import gamut as _gamut


def rgb2lab_1d(in_rgb, device=None) -> np.ndarray:
    """1-d uint8-scale RGB -> Lab."""
    rgb = np.asarray(in_rgb, np.float64)
    if rgb.max() > 1.0 or np.asarray(in_rgb).dtype == np.uint8:
        rgb = rgb / 255.0
    t = torch.as_tensor(rgb.astype(np.float32), device=resolve_device(device))
    return _cs.rgb_to_lab(t).cpu().numpy()


def lab2rgb_1d(in_lab, clip: bool = True, dtype: str = "uint8", device=None):
    """1-d Lab -> RGB; ``dtype='uint8'`` rounds."""
    t = torch.as_tensor(np.asarray(in_lab, np.float32),
                        device=resolve_device(device))
    rgb = _cs.lab_to_rgb(t).cpu().numpy()
    if clip:
        rgb = np.clip(rgb, 0, 1)
    if dtype == "uint8":
        rgb = np.round(rgb * 255).astype("uint8")
    return rgb


def qcolor2lab_1d(qc, device=None) -> np.ndarray:
    """A QColor (anything with red(), green(), blue()) -> Lab."""
    return rgb2lab_1d(np.array([qc.red(), qc.green(), qc.blue()], np.uint8),
                      device)


def snap_ab(input_l, input_rgb, return_type: str = "rgb", device=None):
    """Project a picked color into the sRGB gamut at lightness input_l."""
    t = torch.as_tensor(np.asarray(input_rgb, np.float32),
                        device=resolve_device(device))
    rgb = _gamut.snap_ab(float(input_l), t).cpu().numpy().astype(np.uint8)
    if return_type == "rgb":
        return rgb
    return rgb2lab_1d(rgb, device)


class abGrid:
    """The gamut widget's ab plane."""

    def __init__(self, gamut_size: int = 110, D: int = 1, device=None):
        self.device = resolve_device(device)
        self.D = D
        self.gamut_size = gamut_size
        r = np.arange(-gamut_size, gamut_size + D, D)
        self.vals_b, self.vals_a = np.meshgrid(r, r)
        self.pts_full_grid = np.stack([self.vals_a, self.vals_b], axis=2)
        self.A, self.B = self.pts_full_grid.shape[:2]
        self.AB = self.A * self.B
        self._cache: dict[float, tuple[np.ndarray, np.ndarray]] = {}

    def update_gamut(self, l_in):
        key = round(float(l_in), 3)
        if key not in self._cache:
            if len(self._cache) >= 512:    # bounded: ~200 KB per entry, and
                self._cache.clear()        # every pixel may bring a new L
            masked_rgb, mask = _gamut.ab_gamut_mask(
                float(l_in), gamut_size=self.gamut_size, D=self.D,
                device=self.device)
            self._cache[key] = (masked_rgb.cpu().numpy(), mask.cpu().numpy())
        self.masked_rgb, self.mask = self._cache[key]
        self.pts_rgb = self.masked_rgb
        return self.masked_rgb, self.mask

    def ab2xy(self, a, b):
        return self.gamut_size + b, self.gamut_size + a

    def xy2ab(self, x, y):
        return y - self.gamut_size, x - self.gamut_size
