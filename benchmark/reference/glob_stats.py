"""The global ab histogram of a reference image, the ``glob_ab_313`` blob
that the global-hints net is fed: the weightless graph
``models/global_model/global_stats.prototxt`` of the reference application
(Zhang et al. 2017, arXiv:1705.02999, section 3.3), in plain torch.

RGB in [0, 1] -> Lab (``reference.color``) -> a 4 x 4 average pool of ab
(stride 4) -> the nearest of the 313 bin centers (``reference.bins``) of
each pooled pixel, one-hot -> the mean over pooled pixels.

Departures from the prototxt, none of which changes the histogram:

- its input is a BGR blob that a Python layer turns into Lab; here the
  image is RGB and the Lab is ``reference.color``'s sRGB D65 formula;
- its ``NNEncLayer`` soft-encodes with one neighbour, which is the hard
  one-hot of the nearest bin; here the nearest bin is found by the direct
  squared distance to every center, at float32 (ties go to the lower bin
  index);
- the HSV and BGR means it also computes, and the keep flag its
  ``ColorGlobalDropoutLayer`` appends (always 1 at inference), are left
  out: the net's saturation input is fed zeros, and the flag is appended
  where the net's blob is made.

At TF32 (the check's control) the distance is taken as the product
expansion ``|x|^2 - 2 x.c + |c|^2`` with the product's inputs rounded to
TF32's 10 mantissa bits, as a tensor core rounds them. The rounding is
written out: for a product of inner size 2 cuBLAS takes no tensor core, so
allowing TF32 alone leaves the product in float32 (H100)."""

from __future__ import annotations

import torch

from reference.bins import pts_in_hull
from reference.color import rgb_to_lab


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def histogram(rgb: torch.Tensor, prec: str = "float32") -> torch.Tensor:
    """(..., H, W, 3) float RGB in [0, 1], H and W multiples of 4 ->
    (..., 313) float32 histogram (each row sums to 1). ``prec``: "float32"
    or "tf32"."""
    ab = rgb_to_lab(rgb.to(torch.float32))[..., 1:]
    *lead, h, w, _ = ab.shape
    pooled = ab.reshape(*lead, h // 4, 4, w // 4, 4, 2).mean(dim=(-4, -2))
    x = pooled.reshape(*lead, -1, 2)
    c = torch.from_numpy(pts_in_hull()).to(x.device)
    if prec == "float32":
        d2 = ((x[..., :, None, :] - c) ** 2).sum(-1)
    elif prec == "tf32":
        d2 = ((x * x).sum(-1, keepdim=True) - 2.0 * (_tf32(x) @ _tf32(c).T)
              + (c * c).sum(-1))
    else:
        raise ValueError(f"no histogram at precision {prec!r}")
    near = d2.argmin(-1)
    counts = torch.zeros((*lead, c.shape[0]), device=x.device)
    counts.scatter_add_(-1, near, torch.ones_like(near, dtype=torch.float32))
    return counts / near.shape[-1]
