"""Kernel K2: fused Lab -> clipped, truncated uint8 RGB (``csrc/
colorspace_kernel.cu``), with three entry points.

- :func:`lab_to_rgb_u8_hwc` (the compose) is the counterpart of
  ``ideepcolor_tpu/ops/pallas/colorspace_kernel.py`` (``lab_to_rgb_u8_planar``
  and its wrapper ``compose_frame_u8``, with the same signatures here). It is
  the compose of the full-res, mask, sup and gray getters.
- :func:`lab_to_rgb_u8_ab` (the click's fused entry) also returns the ab of
  the uint8 frame's own Lab, which the JAX click computes in the same XLA
  program (``requantized_ab``). Both clicks call it.
- :func:`lab_to_rgb_u8_batch` composes N frames in one launch from (N, H, W)
  planes with a batch stride each: the batch engine's compose (the JAX
  package's ``lab_to_rgb_u8`` of an (N, H, W, 3) Lab batch).

The kernel reads the three planes through their own strides, so callers
pass views of whatever layout they hold; :func:`load_modes` picks, from the
strides and alignment, how each plane is loaded (one of a few compiled
instantiations). On a CPU tensor a wrapper returns the plain version
(:func:`lab_to_rgb_u8_plain`, then ``ops.colorspace.requantized_ab``); on a
CUDA tensor it launches the kernel or raises, and never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from .. import colorspace as cs
from ..colorspace import WHITE, XYZ2RGB
from .build import Kernel

_PLANES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] * 3
_SHAPE = [ctypes.c_int] * 4                 # height, width, l_mode, ab_mode
_REPLACES = "ideepcolor_tpu/ops/pallas/colorspace_kernel.py:78"

KERNEL = Kernel(
    name="lab_to_rgb_u8",
    source="colorspace_kernel.cu",
    symbol="ideepcolor_lab_to_rgb_u8",
    argtypes=_PLANES + _SHAPE + [ctypes.c_void_p, ctypes.c_void_p],
    replaces=_REPLACES,
)
# The fused click entry: a second symbol of the same library.
KERNEL_AB = Kernel(
    name="lab_to_rgb_u8_ab",
    source="colorspace_kernel.cu",
    symbol="ideepcolor_lab_to_rgb_u8_ab",
    argtypes=_PLANES + _SHAPE + [ctypes.c_void_p] * 4,
    replaces=_REPLACES,
)

# The batched compose: a third symbol; each plane also has a batch stride.
KERNEL_BATCH = Kernel(
    name="lab_to_rgb_u8_batch",
    source="colorspace_kernel.cu",
    symbol="ideepcolor_lab_to_rgb_u8_batch",
    argtypes=[ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int] * 3
    + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p],
    replaces=_REPLACES,
)

# How the kernel loads a plane (the source's Mode): float4 loads, scalar
# loads through the strides, or one load of a stride-0 plane.
VEC, ANY, ZERO = 0, 1, 2
_INT32 = 2 ** 31

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


def _plane_mode(t: torch.Tensor, width: int) -> int:
    """For an (H, W) plane, or an (N, H, W) batch of them."""
    *sb, sy, sx = t.stride()
    if not any(t.stride()):
        return ZERO
    # float4 loads of a group starting at a 4-aligned flat output index
    # land on 16 bytes iff the plane starts there and its rows (and its
    # frames) drift from the output's by a multiple of 4 elements
    if (sx == 1 and t.data_ptr() % 16 == 0 and (sy - width) % 4 == 0
            and all((s - t.shape[-2] * width) % 4 == 0 for s in sb)):
        return VEC
    return ANY


def load_modes(l: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               fused: bool = False) -> tuple[int, int]:
    """The kernel instantiation for these (H, W) planes, or (N, H, W)
    batches of planes: (L mode, ab mode).

    a and b share one mode, ANY where theirs differ. The compose is built
    for a VEC L with any ab mode, the fused entry for (VEC, VEC), the
    click's layout; every other layout takes (ANY, ANY)."""
    W = l.shape[-1]
    am, bm = _plane_mode(a, W), _plane_mode(b, W)
    abm = am if am == bm else ANY
    if _plane_mode(l, W) != VEC or (fused and abm != VEC):
        return ANY, ANY
    return VEC, abm


def _check_planes(name: str, l: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, batch: bool = False) -> tuple[int, ...]:
    planes = (l, a, b)
    dims = 3 if batch else 2
    if l.device.type != "cuda" or any(t.device != l.device for t in planes):
        raise ValueError(f"{name}: L, a and b must lie on one CUDA device "
                         f"(or the CPU), got "
                         f"{[str(t.device) for t in planes]}")
    if any(t.dtype != torch.float32 for t in planes):
        raise ValueError(f"{name}: planes must be float32, got "
                         f"{[t.dtype for t in planes]}")
    if any(t.dim() != dims or t.shape != l.shape for t in planes):
        raise ValueError(f"{name}: want three "
                         f"{'(N, H, W)' if batch else '(H, W)'} planes, got "
                         f"{[tuple(t.shape) for t in planes]}")
    if any(s < 0 for t in planes for s in t.stride()):
        raise ValueError(f"{name}: negative strides are not taken")
    *N, H, W = l.shape
    # 32-bit offsets in the kernel; rows and frames on the grid's y and z
    if (H > 65535 or any(n > 65535 for n in N)
            or 3 * l.numel() >= _INT32
            or any(sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
                   >= _INT32 for t in planes)):
        raise ValueError(f"{name}: {tuple(l.shape)} planes with strides "
                         f"{[t.stride() for t in planes]} are past the "
                         f"kernel's 32-bit offsets or 65535 rows or frames")
    return tuple(l.shape)


def _launch(kernel: Kernel, l, a, b, *outs) -> None:
    lm, abm = load_modes(l, a, b, fused=kernel is KERNEL_AB)
    args = []
    for t in (l, a, b):
        args += [t.data_ptr(), t.stride(0), t.stride(1)]
    kernel.launch(*args, *l.shape, lm, abm, *outs,
                  torch.cuda.current_stream(l.device).cuda_stream)


def lab_to_rgb_u8_hwc(l: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """(H, W) f32 L, a, b planes of any strides -> (H, W, 3) uint8 frame."""
    if l.device.type == "cpu":
        return lab_to_rgb_u8_plain(l, a, b)
    H, W = _check_planes("lab_to_rgb_u8", l, a, b)
    KERNEL.load()                       # no library -> raise, allocate nothing
    out = torch.empty((H, W, 3), dtype=torch.uint8, device=l.device)
    if H * W:
        _launch(KERNEL, l, a, b, out.data_ptr())
    return out


_SRGB_LUT: dict = {}


def srgb_lut(device: torch.device) -> torch.Tensor:
    """srgb_to_linear(v / 255) for v in 0..255, (256,) f32 on ``device``:
    the fused entry's table, made once per device with the plain version's
    own ops (``ops.colorspace.requantized_ab``)."""
    lut = _SRGB_LUT.get(device)
    if lut is None:
        v = torch.arange(256, dtype=torch.uint8, device=device)
        lut = _SRGB_LUT[device] = cs.srgb_to_linear(
            v.to(torch.float32) / 255.0).contiguous()
    return lut


def lab_to_rgb_u8_ab(l: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The click's fused entry: (H, W) f32 L, a, b planes -> (rgb (H, W, 3)
    uint8, ab (H, W, 2) f32), where ab is the Lab ab of the uint8 frame
    itself (``requantized_ab(rgb)``), computed in the kernel's epilogue."""
    if l.device.type == "cpu":
        rgb = lab_to_rgb_u8_plain(l, a, b)
        return rgb, cs.requantized_ab(rgb)
    H, W = _check_planes("lab_to_rgb_u8_ab", l, a, b)
    KERNEL_AB.load()                    # no library -> raise, allocate nothing
    rgb = torch.empty((H, W, 3), dtype=torch.uint8, device=l.device)
    ab = torch.empty((H, W, 2), dtype=torch.float32, device=l.device)
    if H * W:
        _launch(KERNEL_AB, l, a, b, rgb.data_ptr(), ab.data_ptr(),
                srgb_lut(l.device).data_ptr())
    return rgb, ab


def lab_to_rgb_u8_batch(l: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """(N, H, W) f32 L, a, b planes of any strides -> (N, H, W, 3) uint8
    frames, one launch. The plain version is :func:`lab_to_rgb_u8_plain`,
    which is elementwise and takes the batch as it is."""
    if l.device.type == "cpu":
        return lab_to_rgb_u8_plain(l, a, b)
    N, H, W = _check_planes("lab_to_rgb_u8_batch", l, a, b, batch=True)
    KERNEL_BATCH.load()                 # no library -> raise, allocate nothing
    out = torch.empty((N, H, W, 3), dtype=torch.uint8, device=l.device)
    if N * H * W:
        lm, abm = load_modes(l, a, b)
        args = []
        for t in (l, a, b):
            args += [t.data_ptr(), *t.stride()]
        KERNEL_BATCH.launch(*args, N, H, W, lm, abm, out.data_ptr(),
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
