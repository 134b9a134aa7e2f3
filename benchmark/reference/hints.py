"""A hint table -> dense hint planes: inclusive boxes [y1, x1, y2, x2] of
one ab value each, drawn in order so that a later hint wins where boxes
overlap (``cv2.rectangle`` filled, as the reference application draws)."""

from __future__ import annotations

import numpy as np


def rasterize(boxes, values, count: int, size: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """-> ab (2, size, size) float32 and mask (1, size, size) float32 in
    {0, 1}. Boxes are clipped to the frame; an empty box draws nothing."""
    ab = np.zeros((2, size, size), np.float32)
    mask = np.zeros((1, size, size), np.float32)
    for (y1, x1, y2, x2), v in zip(np.asarray(boxes)[:count],
                                   np.asarray(values, np.float32)[:count]):
        y1, x1 = max(int(y1), 0), max(int(x1), 0)
        y2, x2 = min(int(y2), size - 1), min(int(x2), size - 1)
        if y1 > y2 or x1 > x2:
            continue
        ab[:, y1:y2 + 1, x1:x2 + 1] = v[:, None, None]
        mask[:, y1:y2 + 1, x1:x2 + 1] = 1.0
    return ab, mask
