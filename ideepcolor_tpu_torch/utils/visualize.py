"""Image-grid visualization + pickle IO + debug trace helpers.

Equivalents of the reference's ``ui/utils.py`` (grid_vis:86,
average_image:64, PickleCache, debug_trace). Pure numpy: the port's own
copy of ``ideepcolor_tpu/utils/visualize.py``."""

from __future__ import annotations

import os
import pickle

import numpy as np


def debug_trace():
    """Drop into an interactive debugger (ref ui/utils.py debug_trace)."""
    import pdb
    pdb.set_trace()


def save_pickle(obj, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def average_image(imgs: np.ndarray) -> np.ndarray:
    """Mean over a stack of images (N,H,W,C) -> (H,W,C)
    (ref ui/utils.py:64)."""
    return np.mean(np.asarray(imgs, np.float64), axis=0)


def grid_vis(X: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Tile N=(nh*nw) images (N,H,W,C) into one (nh*H, nw*W, C) canvas
    (ref ui/utils.py:86-100)."""
    if X.shape[0] < nh * nw:
        pad = np.zeros((nh * nw - X.shape[0],) + X.shape[1:], X.dtype)
        X = np.concatenate([X, pad], axis=0)
    h, w = X.shape[1:3]
    c = X.shape[3] if X.ndim == 4 else 1
    img = np.zeros((h * nh, w * nw, c), X.dtype)
    for n, x in enumerate(X[:nh * nw]):
        i, j = n // nw, n % nw
        img[i * h:(i + 1) * h, j * w:(j + 1) * w] = x.reshape(h, w, c)
    return img.squeeze() if c == 1 else img
