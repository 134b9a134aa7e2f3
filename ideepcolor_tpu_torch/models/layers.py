"""Layout converters between the JAX package's HWIO weights and torch.

Counterpart of the converters of ``ideepcolor_tpu/models/layers.py``
(:102-125). The JAX package stores a regular conv as HWIO and a
``ConvTranspose2d(k=4, s=2, p=1)`` as the SPATIALLY FLIPPED HWIO kernel of
the equivalent lhs-dilated conv. Going back to torch's (I, O, H, W) deconv
layout therefore needs the un-flip of :func:`hwio_to_torch_convT`; a plain
transpose gives a model that runs and is wrong.
"""

from __future__ import annotations

import numpy as np


def torch_conv_to_hwio(w) -> np.ndarray:
    """torch Conv2d weight (O, I, H, W) -> HWIO."""
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0))


def torch_convT_to_hwio(w) -> np.ndarray:
    """torch ConvTranspose2d weight (I, O, H, W) -> flipped HWIO."""
    return np.ascontiguousarray(
        np.asarray(w)[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))


def hwio_to_torch_conv(w) -> np.ndarray:
    """HWIO -> torch Conv2d (O, I, H, W); inverse of torch_conv_to_hwio."""
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def hwio_to_torch_convT(w) -> np.ndarray:
    """Flipped HWIO (H, W, I, O) -> torch ConvTranspose2d (I, O, H, W);
    inverse of torch_convT_to_hwio."""
    return np.ascontiguousarray(
        np.asarray(w).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
