"""Kernel K2: fused Lab -> clipped, truncated uint8 RGB (``csrc/
colorspace_kernel.cu``).

Counterpart of ``ideepcolor_tpu/ops/pallas/colorspace_kernel.py``
(``lab_to_rgb_u8_planar`` and its wrapper ``compose_frame_u8``), with the
same signatures. It is the compose of every frame on the port's main path:
the click, the full-res getter, the mask, sup and gray getters.

The kernel reads the three planes through their own strides, so callers
pass views of whatever layout they hold; the frame comes out (H, W, 3).
On a CPU tensor the wrapper returns the plain version
(:func:`lab_to_rgb_u8_plain`); on a CUDA tensor it launches the kernel or
raises, and never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..colorspace import WHITE, XYZ2RGB
from .build import Kernel

KERNEL = Kernel(
    name="lab_to_rgb_u8",
    source="colorspace_kernel.cu",
    symbol="ideepcolor_lab_to_rgb_u8",
    argtypes=[ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
              ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
              ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
              ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
              ctypes.c_void_p],
    replaces="ideepcolor_tpu/ops/pallas/colorspace_kernel.py:78",
)

_KAPPA = 24389.0 / 27.0


def _finv(ft: torch.Tensor) -> torch.Tensor:
    return torch.where(ft > 6.0 / 29.0, ft * ft * ft,
                       (116.0 * ft - 16.0) / _KAPPA)


def _to_u8(lin: torch.Tensor) -> torch.Tensor:
    safe = lin.clamp_min(0.0)
    s = torch.where(lin <= 0.0031308, lin * 12.92,
                    1.055 * safe ** (1.0 / 2.4) - 0.055)
    return (s.clamp(0.0, 1.0) * 255.0).to(torch.int32).to(torch.uint8)


def lab_to_rgb_u8_plain(l: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: (H, W) f32 L, a, b -> (H, W, 3) uint8,
    the Pallas kernel's chain in torch f32, with the JAX compose's XYZ->RGB
    matrix (see ``ops.colorspace.XYZ2RGB``)."""
    l, a, b = (t.to(torch.float32) for t in (l, a, b))
    fy = (l + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    x = _finv(fx) * WHITE[0]
    y = _finv(fy) * WHITE[1]
    z = _finv(fz) * WHITE[2]
    m = XYZ2RGB
    return torch.stack([_to_u8(m[c][0] * x + m[c][1] * y + m[c][2] * z)
                        for c in range(3)], dim=-1)


def lab_to_rgb_u8_hwc(l: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """(H, W) f32 L, a, b planes of any strides -> (H, W, 3) uint8 frame."""
    if l.device.type == "cpu":
        return lab_to_rgb_u8_plain(l, a, b)
    planes = (l, a, b)
    if l.device.type != "cuda" or any(t.device != l.device for t in planes):
        raise ValueError("lab_to_rgb_u8: L, a and b must lie on one CUDA "
                         "device (or the CPU), got "
                         f"{[str(t.device) for t in planes]}")
    if any(t.dtype != torch.float32 for t in planes):
        raise ValueError("lab_to_rgb_u8: planes must be float32, got "
                         f"{[t.dtype for t in planes]}")
    if any(t.dim() != 2 or t.shape != l.shape for t in planes):
        raise ValueError("lab_to_rgb_u8: want three (H, W) planes, got "
                         f"{[tuple(t.shape) for t in planes]}")
    if any(s < 0 for t in planes for s in t.stride()):
        raise ValueError("lab_to_rgb_u8: negative strides are not taken")
    H, W = l.shape
    KERNEL.load()                       # no library -> raise, allocate nothing
    out = torch.empty((H, W, 3), dtype=torch.uint8, device=l.device)
    if H * W == 0:
        return out
    args = []
    for t in planes:
        args += [t.data_ptr(), t.stride(0), t.stride(1)]
    KERNEL.launch(*args, H, W, out.data_ptr(),
                  torch.cuda.current_stream(l.device).cuda_stream)
    return out


def lab_to_rgb_u8_planar(l: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """(H, W) L/a/b planes -> (3, H, W) uint8 RGB, the JAX signature (a view
    of the kernel's interleaved frame)."""
    return lab_to_rgb_u8_hwc(l, a, b).permute(2, 0, 1)


def compose_frame_u8(img_l: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """(H, W, 1) L + (H, W, 2) ab -> (H, W, 3) uint8 RGB. The Pallas
    wrapper's tile padding existed for its VMEM budget; this kernel masks
    its own ragged edge, so there is none."""
    return lab_to_rgb_u8_hwc(img_l[..., 0], ab[..., 0], ab[..., 1])
