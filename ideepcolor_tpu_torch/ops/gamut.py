"""sRGB-gamut projection and gamut mask on the device.

Counterpart of ``ideepcolor_tpu/ops/gamut.py``:
  * :func:`snap_ab`: at most 20 lab->rgb->lab round trips per color pick,
    over any batch of colors at once;
  * :func:`ab_gamut_mask`: the 221x221 lab->rgb->lab round trip of a gamut
    redraw.

The reference quantizes to uint8 RGB inside these loops (it feeds a uint8
widget); that rounding is kept: ``snap_ab`` rounds, ``ab_gamut_mask``
truncates.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from . import colorspace as cs


def snap_ab(input_l, input_rgb: torch.Tensor,
            max_iters: int = 20) -> torch.Tensor:
    """Project (L, rgb-derived ab) into the sRGB gamut.

    input_l: scalar or (...,) lightness; input_rgb: (..., 3) uint8-scale
    RGB, a tensor on the device to run on. L is overwritten each iteration
    and the color round-trips through clipped RGB until the largest Lab
    delta OF THE BATCH is below 1 (or ``max_iters``). The stop is a host
    decision, so each iteration reads one flag back (one sync; a color pick
    takes a few). Returns RGB in uint8 scale (0..255 float; the caller
    casts)."""
    lab = cs.rgb_to_lab(input_rgb.to(torch.float32) / 255.0)
    input_l = torch.as_tensor(input_l, dtype=torch.float32,
                              device=lab.device).expand(lab.shape[:-1])
    for _ in range(max_iters):
        old = torch.cat([input_l[..., None], lab[..., 1:]], -1)
        lab = cs.rgb_to_lab(cs.lab_to_rgb(old))     # lab_to_rgb clips
        if not bool((lab - old).abs().sum(-1).max() >= 1.0):
            break
    # the final uint8 quantization rounds
    return torch.round(cs.lab_to_rgb(lab).clamp(0.0, 1.0) * 255.0)


def snap_ab_lab(input_l, input_rgb: torch.Tensor) -> torch.Tensor:
    """:func:`snap_ab` returning Lab."""
    return cs.rgb_to_lab(snap_ab(input_l, input_rgb) / 255.0)


def ab_gamut_mask(l_in: float, gamut_size: int = 110, D: int = 1,
                  device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """In-gamut mask + display RGB over the (2G/D+1)^2 ab plane at fixed L.

    Returns (masked_rgb uint8 (A, B, 3) with out-of-gamut cells set to 255,
    mask bool (A, B)): round trip through uint8 RGB, mask where the Lab L2
    delta < 1. Rows are a, columns are b."""
    dev = resolve_device(device)
    r = torch.arange(-gamut_size, gamut_size + D, D, dtype=torch.float32,
                     device=dev)
    a, b = torch.meshgrid(r, r, indexing="ij")
    lab = torch.stack([torch.full_like(a, float(l_in)), a, b], -1)
    # the reference truncates here (.astype('uint8')), unlike snap_ab
    rgb_u8f = torch.floor(cs.lab_to_rgb(lab).clamp(0.0, 1.0) * 255.0)
    lab_back = cs.rgb_to_lab(rgb_u8f / 255.0)
    mask = ((lab - lab_back) ** 2).sum(-1).sqrt() < 1.0
    masked_rgb = torch.where(mask[..., None], rgb_u8f, 255.0)
    return masked_rgb.to(torch.uint8), mask
