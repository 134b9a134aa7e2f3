"""sRGB-gamut projection and gamut mask on the device.

Counterpart of ``ideepcolor_tpu/ops/gamut.py``:
  * :func:`snap_ab`: 20 lab->rgb->lab round trips per color pick, frozen
    once the batch converges, over any batch of colors at once;
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

    input_l: a number or a (...,) tensor of lightness; input_rgb: (..., 3)
    uint8-scale RGB, a tensor on the device to run on. L is overwritten
    each iteration and the color round-trips through clipped RGB until the
    largest Lab delta OF THE BATCH is below 1 (or ``max_iters``): JAX's
    ``while_loop``, run here as ``max_iters`` iterations each masked by a
    device flag that freezes the colors once the batch has converged, so
    nothing is read back and a CUDA graph can hold the whole loop. On the
    CPU the loop stops at the freeze, which changes no byte. Returns RGB in
    uint8 scale (0..255 float; the caller casts)."""
    lab = cs.rgb_to_lab(input_rgb.to(torch.float32) / 255.0)
    input_l = torch.as_tensor(input_l, dtype=torch.float32,
                              device=lab.device).expand(lab.shape[:-1])
    active = torch.ones((), dtype=torch.bool, device=lab.device)
    for _ in range(max_iters):
        old = torch.cat([input_l[..., None], lab[..., 1:]], -1)
        new = cs.rgb_to_lab(cs.lab_to_rgb(old))     # lab_to_rgb clips
        lab = torch.where(active, new, lab)
        # JAX's test ``dif >= 1``: false for NaN as for a small delta
        active = active & ((new - old).abs().sum(-1).max() >= 1.0)
        if _stop_on_host(active):
            break
    # the final uint8 quantization rounds
    return torch.round(cs.lab_to_rgb(lab).clamp(0.0, 1.0) * 255.0)


def _stop_on_host(active: torch.Tensor) -> bool:
    """On the CPU reading the flag waits for nothing: the loop stops at the
    freeze, and the frozen iterations it skips would change no byte."""
    return active.device.type == "cpu" and not bool(active)


def snap_ab_lab(input_l, input_rgb: torch.Tensor) -> torch.Tensor:
    """:func:`snap_ab` returning Lab."""
    return cs.rgb_to_lab(snap_ab(input_l, input_rgb) / 255.0)


def ab_gamut_mask(l_in, gamut_size: int = 110, D: int = 1,
                  device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """In-gamut mask + display RGB over the (2G/D+1)^2 ab plane at fixed L.

    ``l_in`` is a number, or a 0-d or one-element tensor on the device to
    run on (a graph reads the live L). Returns (masked_rgb uint8 (A, B, 3)
    with out-of-gamut cells set to 255, mask bool (A, B)): round trip
    through uint8 RGB, mask where the Lab L2 delta < 1. Rows are a, columns
    are b."""
    dev = (l_in.device if isinstance(l_in, torch.Tensor)
           else resolve_device(device))
    r = torch.arange(-gamut_size, gamut_size + D, D, dtype=torch.float32,
                     device=dev)
    a, b = torch.meshgrid(r, r, indexing="ij")
    L = torch.as_tensor(l_in, dtype=torch.float32, device=dev).reshape(())
    lab = torch.stack([L.expand(a.shape), a, b], -1)
    # the reference truncates here (.astype('uint8')), unlike snap_ab
    rgb_u8f = torch.floor(cs.lab_to_rgb(lab).clamp(0.0, 1.0) * 255.0)
    lab_back = cs.rgb_to_lab(rgb_u8f / 255.0)
    mask = ((lab - lab_back) ** 2).sum(-1).sqrt() < 1.0
    masked_rgb = torch.where(mask[..., None], rgb_u8f, 255.0)
    return masked_rgb.to(torch.uint8), mask
