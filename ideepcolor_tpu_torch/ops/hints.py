"""User-hint rasterization: the hint table -> (ab, mask) network inputs.

Counterpart of ``ideepcolor_tpu/ops/hints.py``. Hints travel as a
fixed-capacity table: ``MAX_HINTS`` slots of an inclusive box
``[y1, x1, y2, x2]`` and an ab value, plus a live count. Later hints win
where boxes overlap, as ``cv2.rectangle`` overwrites in order.

:func:`rasterize_hints` here is the plain PyTorch version of kernel K1
(``ops/cuda/hints_kernel.py``); the click runs the kernel on the card.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_HINTS = 256


def rasterize_hints(boxes: torch.Tensor, values: torch.Tensor, count,
                    size: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Rasterize hint boxes into dense (ab, mask) planes, plain version.

    boxes (M, 4) int32 inclusive corners, values (M, 2) f32, count the
    number of live hints (an int or a 0-d tensor; slots at and past it are
    ignored). Returns ab (size, size, 2) f32 and mask (size, size, 1) f32 in
    {0, 1}, on the device of ``boxes``. It builds the (M, S, S) membership
    tensor and picks the last covering hint by an argmax over the reversed
    slots, as the JAX function does.
    """
    M = boxes.shape[0]
    dev = boxes.device
    ys = torch.arange(size, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(size, dtype=torch.int32, device=dev)[None, :]
    live = torch.arange(M, device=dev) < count
    b = boxes.to(torch.int32)[:, :, None, None]
    inside = ((ys >= b[:, 0]) & (xs >= b[:, 1]) & (ys <= b[:, 2])
              & (xs <= b[:, 3]) & live[:, None, None])           # (M, S, S)
    mask = inside.any(dim=0)
    # index of the LAST covering hint: argmax (first maximum) over the
    # reversed slots
    last = (M - 1) - inside.flip(0).to(torch.uint8).argmax(dim=0)
    ab = torch.where(mask[..., None], values.to(torch.float32)[last], 0.0)
    return ab, mask[..., None].to(torch.float32)


def put_point(input_ab: np.ndarray, mask: np.ndarray, loc, p, val):
    """Reference notebook helper, host-side: write a (2p+1)^2 patch at loc
    into channel-first (2,H,W) ab and (1,H,W) mask arrays in place."""
    input_ab[:, loc[0] - p:loc[0] + p + 1, loc[1] - p:loc[1] + p + 1] = (
        np.array(val)[:, np.newaxis, np.newaxis])
    mask[:, loc[0] - p:loc[0] + p + 1, loc[1] - p:loc[1] + p + 1] = 1
    return input_ab, mask


def _clamped_point(h, size: int) -> tuple[int, int, int]:
    """One hint dict -> (y, x, radius), the center clamped so the whole
    (2p+1)^2 box lies inside the frame. Raises ValueError on a radius out of
    range; other malformed entries raise what the JAX functions raise
    (KeyError, TypeError, AttributeError)."""
    p = int(h.get("radius", 3))
    if not 0 <= p < size // 2:
        raise ValueError(f"hint radius {p} out of range")
    y = min(max(int(h["y"]), p), size - 1 - p)
    x = min(max(int(h["x"]), p), size - 1 - p)
    return y, x, p


def put_points_json(input_ab: np.ndarray, mask: np.ndarray, hints,
                    size: int):
    """Apply a serve-style hint list of {"y", "x", "ab": [a, b], "radius"}
    dicts to channel-first (2,H,W) ab and (1,H,W) mask arrays in place, with
    validation and edge clamping (``put_point``'s raw slice starts would
    write nothing for a point within ``radius`` of the top or left edge).
    Raises ValueError on malformed payloads. The dense counterpart of
    :func:`points_json_to_table`: both rasterize the same boxes."""
    if hints is None:
        return input_ab, mask
    if not isinstance(hints, list):
        raise ValueError("hints must be a JSON list of point dicts")
    for h in hints:
        y, x, p = _clamped_point(h, size)
        put_point(input_ab, mask, [y, x], p,
                  [float(h["ab"][0]), float(h["ab"][1])])
    return input_ab, mask


def points_json_to_table(hints, size: int):
    """Serve-style hint list of {"y", "x", "ab": [a, b], "radius"} dicts ->
    (boxes, values, count) numpy table, with validation and edge clamping
    (inclusive [y-p, y+p] box, later hints win). Returns None when the list
    exceeds MAX_HINTS; raises ValueError on malformed payloads."""
    boxes = np.zeros((MAX_HINTS, 4), np.int32)
    values = np.zeros((MAX_HINTS, 2), np.float32)
    if hints is None:
        return boxes, values, 0
    if not isinstance(hints, list):
        raise ValueError("hints must be a JSON list of point dicts")
    if len(hints) > MAX_HINTS:
        return None
    for i, h in enumerate(hints):
        y, x, p = _clamped_point(h, size)
        boxes[i] = [y - p, x - p, y + p, x + p]
        values[i] = [float(h["ab"][0]), float(h["ab"][1])]
    return boxes, values, len(hints)
