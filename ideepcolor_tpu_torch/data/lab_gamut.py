"""Host-facing gamut helpers: 1-d color conversions, gamut snap, ab grid.

Counterpart of ``ideepcolor_tpu/data/lab_gamut.py`` (``snap_ab``,
``rgb2lab_1d``, ``lab2rgb_1d``, ``abGrid``), numpy in and out, backed by the
device ops of :mod:`ideepcolor_tpu_torch.ops.gamut`. Each runs on the card
unless the caller passes ``device="cpu"``. On the card ``snap_ab`` and
``abGrid.update_gamut`` are captured CUDA graphs (one per device and input
shape, shared by every caller): a pick is one upload, one graph launch and
one readback, under one module lock, so threads may share them. No Qt: ``qcolor2lab_1d`` takes any object with ``red()``,
``green()`` and ``blue()``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import resolve_device
from ..engine import graphs
from ..ops import colorspace as _cs
from ..ops import gamut as _gamut

# the snap and mask programs, by device
_PROGRAMS: dict = {}
# a replay returns the graph's own output buffers, which the next replay
# overwrites: one caller at a time copies in, replays and reads back
_LOCK = threading.Lock()


def _run(name: str, device: torch.device, *args, **options):
    """Program ``name`` on ``device``, its outputs read back as numpy."""
    with _LOCK:
        prog = _PROGRAMS.get((name, device))
        if prog is None:
            prog = _PROGRAMS[name, device] = graphs.program(
                torch.no_grad()(_snap_packed if name == "snap"
                                else _gamut.ab_gamut_mask), device)
        out = prog(*args, **options)
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy() for o in out)
        return out.cpu().numpy()


def _snap_packed(x: torch.Tensor) -> torch.Tensor:
    """(N, 4) rows [r, g, b, L] -> (N, 3) snapped uint8-scale RGB: one
    input buffer, so a pick uploads once."""
    return _gamut.snap_ab(x[:, 3], x[:, :3])


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
    """Project a picked color (or a batch of them, (..., 3), snapped jointly)
    into the sRGB gamut at lightness input_l."""
    dev = resolve_device(device)
    rgb_in = np.asarray(input_rgb, np.float32)
    x = np.empty((rgb_in.size // 3, 4), np.float32)
    x[:, :3] = rgb_in.reshape(-1, 3)
    x[:, 3] = float(input_l)
    out = _run("snap", dev, torch.from_numpy(x).to(dev))
    rgb = out.astype(np.uint8).reshape(rgb_in.shape)
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
            L = torch.tensor([float(l_in)], dtype=torch.float32)
            self._cache[key] = _run("mask", self.device, L.to(self.device),
                                    gamut_size=self.gamut_size, D=self.D)
        self.masked_rgb, self.mask = self._cache[key]
        self.pts_rgb = self.masked_rgb
        return self.masked_rgb, self.mask

    def ab2xy(self, a, b):
        return self.gamut_size + b, self.gamut_size + a

    def xy2ab(self, x, y):
        return y - self.gamut_size, x - self.gamut_size
