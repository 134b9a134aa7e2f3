"""nd-array reshaping helpers + wall-clock timer.

Equivalents of the reference's ``caffe_files/util.py`` utilities
(flatten_nd_array:15, unflatten_2d_array:32, Timer:68, na:11, check_value).
Pure numpy: the port's own copy of ``ideepcolor_tpu/utils/ndarray.py``.
"""

from __future__ import annotations

import time

import numpy as np


def na():
    """New-axis alias (ref caffe_files/util.py:11-13)."""
    return np.newaxis


def check_value(inds, val) -> bool:
    """True iff every element of ``inds`` equals ``val`` (handles scalars
    and arrays alike; ref caffe_files/util.py:39-51)."""
    if np.array(inds).size == 1:
        if inds == val:
            return True
    return False


def flatten_nd_array(pts_nd: np.ndarray, axis: int = 1) -> np.ndarray:
    """Flatten an nd array into (prod(other axes), C) with C = the size of
    ``axis`` (ref caffe_files/util.py:15-30)."""
    ndim = pts_nd.ndim
    shp = np.array(pts_nd.shape)
    nax = np.setdiff1d(np.arange(ndim), np.array((axis,)))
    npts = int(np.prod(shp[nax]))
    return pts_nd.transpose(np.concatenate((nax, [axis]))).reshape(
        npts, shp[axis])


def unflatten_2d_array(pts_flt: np.ndarray, pts_nd: np.ndarray,
                       axis: int = 1, squeeze: bool = False) -> np.ndarray:
    """Inverse of :func:`flatten_nd_array`
    (ref caffe_files/util.py:32-61). ``pts_nd`` supplies the original
    shape; ``squeeze`` drops the channel axis for scalar channels."""
    ndim = pts_nd.ndim
    shp = np.array(pts_nd.shape)
    nax = np.setdiff1d(np.arange(ndim), np.array((axis,)))
    if squeeze:
        axorder = nax
        new_shp = shp[nax].tolist()
        return pts_flt.reshape(new_shp).transpose(np.argsort(axorder))
    axorder = np.concatenate((nax, [axis]))
    new_shp = shp[nax].tolist() + [pts_flt.shape[1]]
    return pts_flt.reshape(new_shp).transpose(np.argsort(axorder))


class Timer:
    """Context-managed / tic-toc wall-clock timer
    (ref caffe_files/util.py:68-83)."""

    def __init__(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff

    def __enter__(self):
        self.tic()
        return self

    def __exit__(self, *exc):
        self.toc(average=False)
        return False
