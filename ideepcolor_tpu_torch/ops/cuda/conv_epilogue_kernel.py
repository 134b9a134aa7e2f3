"""Kernel K4: the epilogue of a SIGGRAPH conv group, in place on the conv's
output (``csrc/conv_epilogue_kernel.cu``).

A conv of ``models/siggraph.py`` runs without its bias; one K4 launch then
finishes its output: + bias[c]; optionally + a second conv output and its
bias (the U-Net's three skip sums); ReLU, or LeakyReLU with a negative
slope; optionally an inference BatchNorm. The JAX package leaves the same
chain (``ideepcolor_tpu/models/siggraph.py`` ``_block``) to XLA, which
fuses it into the conv.

:func:`conv_epilogue_plain` is the plain version, the eager chain the
SIGGRAPH forward runs elsewhere: the bias add, the skip add, ``F.relu`` or
``F.leaky_relu``, ``F.batch_norm``. :func:`conv_epilogue` launches the
kernel on a CUDA f32 tensor and refuses anything else; it never falls back.
The kernel reads the bias and the BatchNorm's tensors by pointer at each
launch, so a weight written in place reaches the next launch, eager or
replayed in a CUDA graph.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn

from .build import Kernel

KERNEL = Kernel(
    name="conv_epilogue",
    source="conv_epilogue_kernel.cu",
    symbol="ideepcolor_conv_epilogue",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
    + [ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_int,
                               ctypes.c_float, ctypes.c_int,
                               ctypes.c_void_p],
    replaces="ideepcolor_tpu/models/siggraph.py:203",
)

# the kernel's block, its grid's cap (eight blocks of 256 threads fill an
# SM's 2048) and its shared memory: six rows of C floats in 48 KiB
_THREADS = 256
_BLOCKS_PER_SM = 8
_MAX_CHANNELS = 2048
_INT32 = 2 ** 31
_SMS: dict = {}


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor,
                        pair: torch.Tensor | None = None,
                        pair_bias: torch.Tensor | None = None,
                        negative_slope: float | None = None,
                        bn: nn.BatchNorm2d | None = None) -> torch.Tensor:
    """Plain PyTorch version, a new tensor: ``y + bias``, plus ``pair +
    pair_bias`` where given, then ReLU (``negative_slope`` None) or
    LeakyReLU(``negative_slope``), then ``bn`` in inference where given."""
    per_channel = (1, -1, 1, 1)
    v = y + bias.view(per_channel)
    if pair is not None:
        v = v + (pair + pair_bias.view(per_channel))
    v = (F.relu(v) if negative_slope is None
         else F.leaky_relu(v, negative_slope))
    if bn is not None:
        v = F.batch_norm(v, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, 0.0, bn.eps)
    return v


def _f32_cuda(t: torch.Tensor, what: str, device) -> None:
    if t.device != device:
        raise ValueError(f"conv_epilogue: {what} on {t.device}; want the "
                         f"output's device {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"conv_epilogue: {what} must be float32, got "
                         f"{t.dtype}")


def _check(y, bias, pair, pair_bias, bn) -> tuple[bool, bool]:
    """Refuses what the kernel does not take; returns (nhwc, vec)."""
    if y.device.type != "cuda":
        raise ValueError(f"conv_epilogue: y on {y.device}; want a CUDA "
                         f"tensor (the CPU runs conv_epilogue_plain)")
    if y.dtype != torch.float32:
        raise ValueError(f"conv_epilogue: y must be float32, got {y.dtype}")
    if y.dim() != 4:
        raise ValueError(f"conv_epilogue: want an (N, C, H, W) output, got "
                         f"{tuple(y.shape)}")
    N, C, H, W = y.shape
    if not 0 < C <= _MAX_CHANNELS:
        raise ValueError(f"conv_epilogue: {C} channels; the kernel takes "
                         f"1 to {_MAX_CHANNELS}")
    if y.numel() >= _INT32:
        raise ValueError(f"conv_epilogue: {tuple(y.shape)} is past the "
                         f"kernel's 32-bit offsets")
    if y.is_contiguous():
        nhwc = False
    elif y.is_contiguous(memory_format=torch.channels_last):
        nhwc = True
    else:
        raise ValueError("conv_epilogue: y must be contiguous, NCHW or "
                         "channels-last")
    params = [(bias, "bias")]
    if pair is not None:
        if pair_bias is None:
            raise ValueError("conv_epilogue: a pair needs its pair_bias")
        _f32_cuda(pair, "pair", y.device)
        if pair.shape != y.shape or pair.stride() != y.stride():
            raise ValueError(f"conv_epilogue: pair {tuple(pair.shape)} "
                             f"strides {pair.stride()} differ from y's "
                             f"{tuple(y.shape)} strides {y.stride()}")
        params.append((pair_bias, "pair_bias"))
    if bn is not None:
        params += [(bn.running_mean, "running_mean"),
                   (bn.running_var, "running_var"), (bn.weight, "weight"),
                   (bn.bias, "BatchNorm bias")]
    for t, what in params:
        _f32_cuda(t, what, y.device)
        if t.shape != (C,) or not t.is_contiguous():
            raise ValueError(f"conv_epilogue: {what} must be a contiguous "
                             f"({C},) tensor, got {tuple(t.shape)}")
    inner = C if nhwc else H * W
    vec = inner % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (y, pair) if t is not None)
    return nhwc, vec


def _blocks(device: torch.device, units: int) -> int:
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return max(1, min(-(-units // _THREADS), sms * _BLOCKS_PER_SM))


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor,
                  pair: torch.Tensor | None = None,
                  pair_bias: torch.Tensor | None = None,
                  negative_slope: float | None = None,
                  bn: nn.BatchNorm2d | None = None) -> torch.Tensor:
    """K4: :func:`conv_epilogue_plain`'s result written over ``y``, which
    is returned. ``y`` (and ``pair``, in the same layout) a CUDA f32
    (N, C, H, W) tensor, contiguous NCHW or channels-last; ``bias``,
    ``pair_bias`` and ``bn``'s tensors contiguous f32 (C,) on its device.
    ``bn`` is applied in inference, with its running statistics."""
    nhwc, vec = _check(y, bias, pair, pair_bias, bn)
    KERNEL.load()                       # no library -> raise, launch nothing
    N, C, H, W = y.shape
    n = y.numel()
    KERNEL.launch(
        y.data_ptr(), None if pair is None else pair.data_ptr(), n, C, H * W,
        int(nhwc), int(vec), bias.data_ptr(),
        None if pair is None else pair_bias.data_ptr(),
        *((None,) * 4 if bn is None else (
            bn.running_mean.data_ptr(), bn.running_var.data_ptr(),
            bn.weight.data_ptr(), bn.bias.data_ptr())),
        0.0 if bn is None else float(bn.eps),
        int(negative_slope is not None),
        0.0 if negative_slope is None else float(negative_slope),
        _blocks(y.device, n // 4 if vec else n),
        torch.cuda.current_stream(y.device).cuda_stream)
    return y
