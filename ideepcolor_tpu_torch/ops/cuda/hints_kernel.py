"""Kernel K1: hint-table rasterizer (``csrc/hints_kernel.cu``).

Counterpart of ``ideepcolor_tpu/ops/pallas/hints_kernel.py``
``rasterize_hints_pallas``, with the same contract as the plain version
:func:`ideepcolor_tpu_torch.ops.hints.rasterize_hints`: boxes (M, 4) int32
with inclusive corners, values (M, 2) f32 and a live count in; ab and mask
out, last live hint wins, bit-exact with the plain version.

On a CPU tensor the wrapper returns the plain version. On a CUDA tensor it
launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from .. import hints as plain
from .build import Kernel

KERNEL = Kernel(
    name="rasterize_hints",
    source="hints_kernel.cu",
    symbol="ideepcolor_rasterize_hints",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p],
    replaces="ideepcolor_tpu/ops/pallas/hints_kernel.py:59",
)

# Dynamic shared memory (24 B per slot of the culled list) plus the
# kernel's few static bytes stay under the 48 KB a block gets without
# opting in.
_MAX_SLOTS = (48 * 1024 - 64) // 24
# The kernel's offsets are 32-bit: 3 * size * size < 2^31.
_MAX_SIZE = 26754


def rasterize_hints_planar(boxes: torch.Tensor, values: torch.Tensor, count,
                           size: int = 256) -> torch.Tensor:
    """Rasterize into one planar (3, size, size) f32 tensor: planes 0-1 the
    ab hint, plane 2 the mask -- the U-Net's input channel order."""
    if boxes.device.type == "cpu":
        ab, mask = plain.rasterize_hints(boxes, values, count, size)
        return torch.cat([ab, mask], -1).permute(2, 0, 1).contiguous()
    if boxes.device.type != "cuda" or values.device != boxes.device:
        raise ValueError(f"rasterize_hints: boxes on {boxes.device}, values "
                         f"on {values.device}; both must be on one CUDA "
                         f"device (or the CPU)")
    M = boxes.shape[0]
    if (boxes.dtype != torch.int32 or values.dtype != torch.float32
            or tuple(boxes.shape) != (M, 4) or tuple(values.shape) != (M, 2)):
        raise ValueError(
            f"rasterize_hints: want boxes (M,4) int32 and values (M,2) "
            f"float32, got {tuple(boxes.shape)} {boxes.dtype} and "
            f"{tuple(values.shape)} {values.dtype}")
    if not (boxes.is_contiguous() and values.is_contiguous()):
        raise ValueError("rasterize_hints: boxes and values must be "
                         "contiguous")
    if boxes.data_ptr() % 16 or values.data_ptr() % 8:
        raise ValueError("rasterize_hints: boxes must be 16-byte and values "
                         "8-byte aligned")
    if M > _MAX_SLOTS or not 1 <= size <= _MAX_SIZE:
        raise ValueError(f"rasterize_hints: M={M} (at most {_MAX_SLOTS}), "
                         f"size={size} (1 to {_MAX_SIZE})")
    n = min(max(int(count), 0), M)
    KERNEL.load()                       # no library -> raise, allocate nothing
    out = torch.empty((3, size, size), dtype=torch.float32,
                      device=boxes.device)
    KERNEL.launch(boxes.data_ptr(), values.data_ptr(), n, size,
                  out.data_ptr(),
                  torch.cuda.current_stream(boxes.device).cuda_stream)
    return out


def rasterize_hints_cuda(boxes: torch.Tensor, values: torch.Tensor, count,
                         size: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX layout: ab (size, size, 2) and mask (size, size, 1), as views
    of the planar kernel output."""
    planes = rasterize_hints_planar(boxes, values, count, size)
    hwc = planes.permute(1, 2, 0)
    return hwc[..., :2], hwc[..., 2:]
