"""The 313 ab bin centers of the published Caffe models: the cells of the
23x23 ab grid (step 10, -110..110, a slow and b fast) inside the convex
hull of ImageNet's ab values. The hull is a constant of the published
models (``pts_in_hull.npy``), kept here as its 529-bit mask."""

from __future__ import annotations

import numpy as np

_IN_HULL_HEX = (
    "0000000000000003e0003fc001ff800fff003fff00fffe03fffc07fff81ffff07fffe1"
    "ffff83ffff0ffffe3ffffc7ffff1ffffe3ffffc7ffff0ffffe07fe0000000000"
)


def pts_in_hull() -> np.ndarray:
    """(313, 2) float32 bin centers (a, b)."""
    r = np.arange(-110, 120, 10)
    a, b = np.meshgrid(r, r, indexing="ij")
    grid = np.stack([a.ravel(), b.ravel()], 1)
    bits = np.unpackbits(np.frombuffer(bytes.fromhex(_IN_HULL_HEX), np.uint8))
    return grid[bits[:529].astype(bool)].astype(np.float32)
