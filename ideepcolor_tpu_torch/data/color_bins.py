"""Quantized ab-gamut bin tables.

The port's own copy of ``ideepcolor_tpu/data/color_bins.py`` (pure numpy).
Three tiny tables:

  * ``pts_grid``    (529, 2): the full 23x23 ab grid, step 10, [-110, 110],
  * ``in_hull``     (529,) bool: which grid cells fall inside the convex
    hull of empirical ImageNet ab values (a constant of the published model,
    NOT derivable from the sRGB gamut: only 229 bin centers are strictly
    in-gamut, the model's hull keeps 313),
  * ``pts_in_hull`` (313, 2) = pts_grid[in_hull].

The grid is generated; the 529-bit hull mask is a packed constant. The JAX
package's ``get_bins(path=...)`` also loads external ``.npy`` tables for its
Caffe family; that loader comes with that family's port.

Grid ordering: the .npy tables iterate a slowly / b fast, while the SIGGRAPH
backend builds its own grid with np.meshgrid ordering (b slow / a fast, see
``ops.quantize.make_pts_grid``). ``make_grid(order=...)`` gives both.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

GRID_STEP = 10
GRID_LIM = 110
GRID_SIDE = 23          # (-110..110 step 10)
GRID_SIZE = GRID_SIDE * GRID_SIDE   # 529
NUM_IN_HULL = 313

# 529-bit hull-membership mask, packed MSB-first (np.packbits layout).
_IN_HULL_HEX = (
    "0000000000000003e0003fc001ff800fff003fff00fffe03fffc07fff81ffff07fffe1"
    "ffff83ffff0ffffe3ffffc7ffff1ffffe3ffffc7ffff0ffffe07fe0000000000"
)


def make_grid(order: str = "ab") -> np.ndarray:
    """Full 529x2 ab grid. order='ab': a slow/b fast (the .npy convention);
    order='ba': the meshgrid convention of the SIGGRAPH backend."""
    r = np.arange(-GRID_LIM, GRID_LIM + GRID_STEP, GRID_STEP, dtype=np.int64)
    if order == "ab":
        a, b = np.meshgrid(r, r, indexing="ij")
    else:
        b, a = np.meshgrid(r, r, indexing="ij")
    return np.stack([a.ravel(), b.ravel()], axis=1)


def make_in_hull() -> np.ndarray:
    mask = np.unpackbits(np.frombuffer(bytes.fromhex(_IN_HULL_HEX), np.uint8))
    return mask[:GRID_SIZE].astype(bool)


@dataclasses.dataclass(frozen=True)
class ColorBins:
    pts_grid: np.ndarray     # (529, 2) int64
    in_hull: np.ndarray      # (529,) bool
    pts_in_hull: np.ndarray  # (313, 2) int64

    @property
    def K(self) -> int:
        return self.pts_in_hull.shape[0]


@functools.lru_cache(maxsize=None)
def get_bins() -> ColorBins:
    """The built-in tables, built once."""
    grid = make_grid("ab")
    in_hull = make_in_hull()
    return ColorBins(grid, in_hull, grid[in_hull])
