"""Kernel K3: the global color statistics of a reference image
(``csrc/global_stats_kernel.cu``).

Counterpart of ``ideepcolor_tpu/models/global_stats.py`` ``extract``, one
jitted XLA program with no Pallas kernel: (H, W, 3) f32 RGB in [0, 1] ->
the 313-bin ab histogram of the 4 x 4-pooled ab (``glob_ab_313``), the mean
HSV saturation (``s_avg``) and the BGR channel means (``bgr_avg``).

:func:`global_stats_plain` is the plain version: the port's eager chain of
PyTorch ops, which finds the nearest bin by the product expansion. The
kernel finds it by the direct squared distance (the reference's
``NNEncLayer``), so the two may put a pooled pixel within rounding of a bin
boundary in neighbouring bins; everything else follows the chain op by op.

On a CPU tensor :func:`global_stats` returns the plain version. On a CUDA
tensor it launches the kernel or raises; it never falls back. One call is
two launches on the card (the per-block partials, then one finishing
block), counted as one in ``KERNEL.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ...data.color_bins import get_bins
from .. import colorspace as cs
from ..quantize import soft_encode
from .build import Kernel

KERNEL = Kernel(
    name="global_stats",
    source="global_stats_kernel.cu",
    symbol="ideepcolor_global_stats",
    argtypes=[ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_int] + [ctypes.c_void_p] * 5,
    replaces="ideepcolor_tpu/models/global_stats.py:28",
)

BINS = 313
# the partials kernel's pooled pixels a block step, its grid's cap (four
# blocks on each of the H100's 132 SMs) and the words of a block's partials
_PATCHES = 64
_MAX_BLOCKS = 528
_WORDS = 320
# 32-bit offsets in the kernel; counts and pooled pixels exact in f32
_INT32 = 2 ** 31
_F32_EXACT = 2 ** 24


def global_stats_plain(rgb: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (H, W, 3) f32 RGB, H and W divisible by 4 ->
    (glob_ab_313 (313,), s_avg (), bgr_avg (3,)) on ``rgb``'s device."""
    ab = cs.rgb_to_lab(rgb)[..., 1:]
    h, w = ab.shape[0], ab.shape[1]
    ab_rs = ab.reshape(h // 4, 4, w // 4, 4, 2).mean(dim=(1, 3))
    glob = soft_encode(ab_rs, nn=1).mean(dim=(0, 1))
    s_avg = cs.rgb_to_hsv(rgb)[..., 1].mean()
    bgr_avg = rgb.mean(dim=(0, 1)).flip(0)
    return glob, s_avg, bgr_avg


_CENTERS: dict = {}


def bin_centers(device: torch.device) -> torch.Tensor:
    """The 313 bin centers as (313, 2) f32 on ``device``, uploaded once per
    device (the plain version's own table, ``ops.quantize``)."""
    c = _CENTERS.get(device)
    if c is None:
        c = _CENTERS[device] = torch.as_tensor(
            get_bins().pts_in_hull, dtype=torch.float32, device=device)
    return c


def blocks_for(height: int, width: int) -> int:
    """The partials kernel's grid for an (H, W) image: a block for each 64
    pooled pixels, at most ``_MAX_BLOCKS`` (the rest in grid-stride
    steps). Fixed by the shape, so the order of every sum is too."""
    pooled = (height // 4) * (width // 4)
    return min(-(-pooled // _PATCHES), _MAX_BLOCKS)


def _check(rgb: torch.Tensor) -> tuple[int, int]:
    if rgb.device.type != "cuda":
        raise ValueError(f"global_stats: rgb on {rgb.device}; want a CUDA "
                         f"tensor (or a CPU one)")
    if rgb.dtype != torch.float32:
        raise ValueError(f"global_stats: rgb must be float32, got "
                         f"{rgb.dtype}")
    if rgb.dim() != 3 or rgb.shape[2] != 3:
        raise ValueError(f"global_stats: want an (H, W, 3) image, got "
                         f"{tuple(rgb.shape)}")
    H, W = rgb.shape[0], rgb.shape[1]
    if H % 4 or W % 4 or not H * W:
        raise ValueError(f"global_stats: H and W must be positive multiples "
                         f"of 4 (the 4 x 4 pool), got {H} x {W}")
    if not rgb.is_contiguous():
        raise ValueError("global_stats: rgb must be contiguous")
    if rgb.data_ptr() % 16:
        raise ValueError("global_stats: rgb must be 16-byte aligned")
    if 3 * H * W >= _INT32 or H * W // 16 > _F32_EXACT:
        raise ValueError(f"global_stats: {H} x {W} is past the kernel's "
                         f"32-bit offsets or 2^24 pooled pixels")
    return H, W


def global_stats(rgb: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, W, 3) f32 RGB in [0, 1] -> (glob_ab_313 (313,), s_avg (),
    bgr_avg (3,)), new tensors on ``rgb``'s device. On the card: contiguous,
    16-byte aligned, H and W positive multiples of 4."""
    if rgb.device.type == "cpu":
        return global_stats_plain(rgb)
    H, W = _check(rgb)
    KERNEL.load()                       # no library -> raise, allocate nothing
    dev = rgb.device
    blocks = blocks_for(H, W)
    partials = torch.empty(blocks * _WORDS, dtype=torch.int32, device=dev)
    glob = torch.empty(BINS, dtype=torch.float32, device=dev)
    s_avg = torch.empty((), dtype=torch.float32, device=dev)
    bgr_avg = torch.empty(3, dtype=torch.float32, device=dev)
    KERNEL.launch(rgb.data_ptr(), H, W, bin_centers(dev).data_ptr(), blocks,
                  partials.data_ptr(), glob.data_ptr(), s_avg.data_ptr(),
                  bgr_avg.data_ptr(), torch.cuda.current_stream(dev)
                  .cuda_stream)
    return glob, s_avg, bgr_avg
