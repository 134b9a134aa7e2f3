"""Kernel K1: hint-table rasterizer (``csrc/hints_kernel.cu``).

Counterpart of ``ideepcolor_tpu/ops/pallas/hints_kernel.py``
``rasterize_hints_pallas``, with the same contract as the plain version
:func:`ideepcolor_tpu_torch.ops.hints.rasterize_hints`: boxes (M, 4) int32
with inclusive corners, values (M, 2) f32 and a live count in; ab and mask
out, last live hint wins, bit-exact with the plain version.

Two entries of one source. ``KERNEL`` takes the live count by value (an
int on the host). ``KERNEL_BATCH`` takes N tables and their N counts from
device memory, one launch for (N, 3, size, size): the batch engine's
rasterizer (the JAX package's ``jax.vmap(rasterize_hints)``), and with N = 1
the rasterizer of the captured clicks, whose count must be read where the
kernel runs because a CUDA graph freezes every by-value argument.
:func:`rasterize_hints_planar` picks the entry from the type of ``count``.

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

KERNEL_BATCH = Kernel(
    name="rasterize_hints_batch",
    source="hints_kernel.cu",
    symbol="ideepcolor_rasterize_hints_batch",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p],
    replaces="ideepcolor_tpu/ops/pallas/hints_kernel.py:59",
)

# Dynamic shared memory (24 B per slot of the culled list) plus the
# kernel's few static bytes stay under the 48 KB a block gets without
# opting in.
_MAX_SLOTS = (48 * 1024 - 64) // 24
# The kernel's offsets are 32-bit: 3 * size * size < 2^31.
_MAX_SIZE = 26754


def _planar_plain(boxes, values, count, size) -> torch.Tensor:
    ab, mask = plain.rasterize_hints(boxes, values, count, size)
    return torch.cat([ab, mask], -1).permute(2, 0, 1).contiguous()


def rasterize_hints_batch_plain(boxes: torch.Tensor, values: torch.Tensor,
                                counts: torch.Tensor, size: int = 256
                                ) -> torch.Tensor:
    """Plain PyTorch version of the batched entry: a loop of the plain
    rasterizer over the N tables."""
    return torch.stack([_planar_plain(boxes[i], values[i], counts[i], size)
                        for i in range(boxes.shape[0])])


def _check_tables(boxes: torch.Tensor, values: torch.Tensor, lead: tuple,
                  size: int) -> int:
    """Raise on what the kernel does not take; return M. ``lead`` is the
    leading shape: () for one table, (N,) for a batch."""
    if boxes.device.type != "cuda" or values.device != boxes.device:
        raise ValueError(f"rasterize_hints: boxes on {boxes.device}, values "
                         f"on {values.device}; both must be on one CUDA "
                         f"device (or the CPU)")
    M = boxes.shape[-2] if boxes.dim() >= 2 else -1
    if (boxes.dtype != torch.int32 or values.dtype != torch.float32
            or tuple(boxes.shape) != lead + (M, 4)
            or tuple(values.shape) != lead + (M, 2)):
        want = "(N,M,4)" if lead else "(M,4)"
        raise ValueError(
            f"rasterize_hints: want boxes {want} int32 and values "
            f"{want[:-2]}2) float32, got {tuple(boxes.shape)} {boxes.dtype} "
            f"and {tuple(values.shape)} {values.dtype}")
    if not (boxes.is_contiguous() and values.is_contiguous()):
        raise ValueError("rasterize_hints: boxes and values must be "
                         "contiguous")
    if boxes.data_ptr() % 16 or values.data_ptr() % 8:
        raise ValueError("rasterize_hints: boxes must be 16-byte and values "
                         "8-byte aligned")
    if M > _MAX_SLOTS or not 1 <= size <= _MAX_SIZE:
        raise ValueError(f"rasterize_hints: M={M} (at most {_MAX_SLOTS}), "
                         f"size={size} (1 to {_MAX_SIZE})")
    return M


def rasterize_hints_batch(boxes: torch.Tensor, values: torch.Tensor,
                          counts: torch.Tensor, size: int = 256
                          ) -> torch.Tensor:
    """N hint tables in one launch: boxes (N, M, 4) int32, values (N, M, 2)
    f32 and counts (N,) int32, all on one device -> (N, 3, size, size) f32.
    The counts are read on the device (clamped to [0, M]), so the call can
    be captured in a CUDA graph and replayed with other counts."""
    if boxes.device.type == "cpu":
        return rasterize_hints_batch_plain(boxes, values, counts, size)
    N = boxes.shape[0]
    M = _check_tables(boxes, values, (N,), size)
    if (counts.device != boxes.device or counts.dtype != torch.int32
            or tuple(counts.shape) != (N,) or not counts.is_contiguous()):
        raise ValueError(
            f"rasterize_hints: want counts ({N},) int32 on {boxes.device}, "
            f"got {tuple(counts.shape)} {counts.dtype} on {counts.device}")
    if not 1 <= N <= 65535:
        raise ValueError(f"rasterize_hints: N={N} tables (1 to 65535)")
    KERNEL_BATCH.load()                 # no library -> raise, allocate nothing
    out = torch.empty((N, 3, size, size), dtype=torch.float32,
                      device=boxes.device)
    KERNEL_BATCH.launch(boxes.data_ptr(), values.data_ptr(),
                        counts.data_ptr(), N, M, size, out.data_ptr(),
                        torch.cuda.current_stream(boxes.device).cuda_stream)
    return out


def rasterize_hints_planar(boxes: torch.Tensor, values: torch.Tensor, count,
                           size: int = 256) -> torch.Tensor:
    """Rasterize into one planar (3, size, size) f32 tensor: planes 0-1 the
    ab hint, plane 2 the mask -- the U-Net's input channel order. ``count``
    is an int, or an int32 tensor of one element on the tables' device: on
    the card that takes the entry that reads the count where it runs."""
    if boxes.device.type == "cpu":
        return _planar_plain(boxes, values, count, size)
    if isinstance(count, torch.Tensor):
        return rasterize_hints_batch(boxes[None], values[None],
                                     count.reshape(1), size)[0]
    M = _check_tables(boxes, values, (), size)
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
