"""Shared helpers of the Caffe-family port tests: weights made once with
numpy in the port's state-dict layout, and the same weights in the JAX
package's HWIO param layout."""

import numpy as np

from ideepcolor_tpu_torch.models import caffe_net as tcaffe
from ideepcolor_tpu_torch.models import layers as tlayers


def jax_params_from_state_dict(sd, variant):
    """The port's state dict -> the JAX package's param dict (numpy): OIHW
    convs to HWIO, IOHW deconvs to flipped HWIO, the rest as it is."""
    kinds = {c[0]: c[5] for c in tcaffe._convs_for(variant)}
    params = {}
    for key, value in sd.items():
        arr = value.numpy()
        if arr.ndim == 4:
            arr = (tlayers.torch_convT_to_hwio(arr)
                   if kinds[key.split(".")[0]] == "deconv"
                   else tlayers.torch_conv_to_hwio(arr))
        params[key] = arr
    return params


def smooth_image(seed, H, W):
    """A seeded smooth color field with noise, uint8 (H, W, 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * yy + c) * np.cos(5 * xx - 2 * c)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 12, (H, W, 3)),
                   0, 255).astype(np.uint8)


def blob(seed, n, size):
    """A seeded (n, size, size, 4) Caffe blob, channel-last: a smooth
    mean-centered L plane, a few 5x5 hint boxes, the mask x 110."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = np.zeros((n, size, size, 4), np.float32)
    for i in range(n):
        out[i, ..., 0] = (45 * np.sin(5 * yy + i) * np.cos(4 * xx - i)
                          + rng.normal(0, 4, (size, size)))
        for _ in range(1 + i % 3):
            y, x = rng.integers(0, size - 5, 2)
            out[i, y:y + 5, x:x + 5, 1:3] = rng.uniform(-70, 70, 2)
            out[i, y:y + 5, x:x + 5, 3] = 110.0
    return out
