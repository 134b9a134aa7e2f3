"""Headless user-edit model: the hint-point list and its rasterization.

Counterpart of ``ideepcolor_tpu/ui/control.py`` (the reference's
``UIControl`` / ``PointEdit``, ref ui/ui_control.py:7-193) without Qt types,
so the edit logic is testable without a display. Its fast path hands the
table click a (boxes, ab values, count) table instead of dense planes drawn
on the host.

Coordinate conventions follow the reference exactly:
  * points live in window coordinates (win_size x win_size, letterboxed);
  * ``scale_point`` maps them into load_size (network) coordinates
    (ref ui/ui_control.py:23-26);
  * a point of brush ``width`` rasterizes as the inclusive rectangle
    [center-w, center+w] in network coords, w = width/scale
    (ref ui/ui_control.py:52-63);
  * later points overwrite earlier ones; ``is_same`` proximity is
    width+1 per axis (ref ui/ui_control.py:65-68).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import colorspace as cs
from ..ops.hints import MAX_HINTS

# (r, g, b) uint8 tuple -> its Lab, f32 (3,). A hint table needs the Lab of
# every edit's color at every click; the colors repeat from click to click.
_hint_lab_cache: dict[tuple, np.ndarray] = {}


def _lab_for_colors(colors: list[tuple]) -> None:
    """Fill the color->Lab cache for any uncached (r,g,b) uint8 tuples, in
    one conversion for the batch. The colors are a few host values, so they
    are converted on the host (the port's colorspace on CPU tensors)."""
    needed = list(dict.fromkeys(colors))           # <= MAX_HINTS entries
    missing = [c for c in needed if c not in _hint_lab_cache]
    if not missing:
        return
    if len(_hint_lab_cache) + len(missing) > 4096:  # bounded cache:
        _hint_lab_cache.clear()                     # evict BEFORE insert,
        missing = needed                            # keep this call's set
    rgb = np.asarray(missing, np.float32) / 255.0
    labs = cs.rgb_to_lab(torch.from_numpy(rgb)).numpy()
    for c, lab in zip(missing, labs):
        _hint_lab_cache[c] = lab


@dataclasses.dataclass
class PointEdit:
    """One user hint: position (window coords), snapped color, raw user
    color, brush width, and an interaction counter for recency ordering."""
    pnt: tuple[int, int]                      # (x, y) window coords
    color: tuple[int, int, int]               # gamut-snapped RGB
    user_color: tuple[int, int, int]          # as picked by the user
    width: float
    ui_count: int

    def is_same(self, pnt) -> bool:
        return (abs(self.pnt[0] - pnt[0]) <= self.width + 1
                and abs(self.pnt[1] - pnt[1]) <= self.width + 1)


class UIControl:
    """The hint edit list (ref ui/ui_control.py:87-193)."""

    def __init__(self, win_size: int = 256, load_size: int = 512):
        self.win_size = win_size
        self.load_size = load_size
        self.img_size = (win_size, win_size)
        self.reset()

    def setImageSize(self, img_size):
        self.img_size = tuple(img_size)        # (w, h) of the fitted image

    # --- coordinate mapping (ref ui/ui_control.py:14-26) ---
    def _geometry(self):
        dw = int((self.win_size - self.img_size[0]) // 2)
        dh = int((self.win_size - self.img_size[1]) // 2)
        return dw, dh, self.img_size[0], self.img_size[1]

    def scale_point(self, in_x, in_y, w):
        dw, dh, img_w, img_h = self._geometry()
        x = int((in_x - dw) / float(img_w) * self.load_size) + w
        y = int((in_y - dh) / float(img_h) * self.load_size) + w
        return x, y

    # --- edit operations (ref ui/ui_control.py:102-143) ---
    def addPoint(self, pnt, color, user_color, width):
        self.ui_count += 1
        self.userEdit = None
        is_new = True
        for ue in self.userEdits:
            if ue.is_same(pnt):
                self.userEdit = ue
                is_new = False
                break
        if self.userEdit is None:
            self.userEdit = PointEdit(tuple(pnt), tuple(color),
                                      tuple(user_color), width,
                                      self.ui_count)
            self.userEdits.append(self.userEdit)
            return user_color, width, is_new
        # reselect an existing point: adopt its color/width
        self.userEdit.pnt = tuple(pnt)
        self.userEdit.ui_count = self.ui_count
        return self.userEdit.user_color, self.userEdit.width, is_new

    def movePoint(self, pnt, color, user_color, width):
        self.userEdit.pnt = tuple(pnt)
        self.userEdit.color = tuple(color)
        self.userEdit.user_color = tuple(user_color)
        self.userEdit.width = width
        self.userEdit.ui_count = self.ui_count

    def update_color(self, color, user_color):
        self.userEdit.color = tuple(color)
        self.userEdit.user_color = tuple(user_color)

    def erasePoint(self, pnt) -> bool:
        for ue in list(self.userEdits):
            if ue.is_same(pnt):
                self.userEdits.remove(ue)
                return True
        return False

    def used_colors(self):
        """Recently used colors, most recent first, deduplicated
        (ref ui/ui_control.py:148-175). Returns (K,3) floats in [0,1]."""
        if not self.userEdits:
            return None
        order = np.argsort([-ue.ui_count for ue in self.userEdits])
        colors = np.array([self.userEdits[i].user_color for i in order],
                          np.float64)
        unique = []
        for c in colors:
            if not any(np.sum(np.abs(u - c)) < 0.1 for u in unique):
                unique.append(c)
        return np.vstack(unique) / 255.0

    # --- rasterization ---
    def hint_table(self):
        """Fast path: (boxes (MAX_HINTS,4) int32 [y1,x1,y2,x2], ab values
        (MAX_HINTS,2) f32, count) for the table clicks, whose kernel K1
        rasterizes them on the device."""
        boxes = np.zeros((MAX_HINTS, 4), np.int32)
        vals = np.zeros((MAX_HINTS, 2), np.float32)
        n = min(len(self.userEdits), MAX_HINTS)
        max_width = max(self.img_size)
        scale = float(max_width) / self.load_size
        _lab_for_colors([tuple(ue.color) for ue in self.userEdits[:n]])
        for i, ue in enumerate(self.userEdits[:n]):
            w = int(ue.width / scale)
            x1, y1 = self.scale_point(ue.pnt[0], ue.pnt[1], -w)
            x2, y2 = self.scale_point(ue.pnt[0], ue.pnt[1], w)
            boxes[i] = [y1, x1, y2, x2]
            vals[i] = _hint_lab_cache[tuple(ue.color)][1:]
        return boxes, vals, n

    def get_input(self):
        """Parity path (ref ui/ui_control.py:177-187): dense uint8
        (im, mask) planes at load_size, drawn in insertion order."""
        h = w = self.load_size
        im = np.zeros((h, w, 3), np.uint8)
        mask = np.zeros((h, w, 1), np.uint8)
        max_width = max(self.img_size)
        scale = float(max_width) / self.load_size
        for ue in self.userEdits:
            pw = int(ue.width / scale)
            x1, y1 = self.scale_point(ue.pnt[0], ue.pnt[1], -pw)
            x2, y2 = self.scale_point(ue.pnt[0], ue.pnt[1], pw)
            y1c, y2c = max(y1, 0), min(y2, h - 1)
            x1c, x2c = max(x1, 0), min(x2, w - 1)
            if y1c <= y2c and x1c <= x2c:
                im[y1c:y2c + 1, x1c:x2c + 1] = ue.color
                mask[y1c:y2c + 1, x1c:x2c + 1] = 255
        return im, mask

    def reset(self):
        self.userEdits: list[PointEdit] = []
        self.userEdit: PointEdit | None = None
        self.ui_count = 0
