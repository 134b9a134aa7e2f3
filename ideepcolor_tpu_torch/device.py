"""Device choice and the f32 parity rule for the port's entry points.

Entry points run on the card unless the caller asks for the CPU with
``device="cpu"``. Without a usable card, a call that did not ask for the CPU
raises; it never quietly runs on the CPU.

Parity mode is f32: the JAX package runs its convs and resize contractions
at ``Precision.HIGHEST``. cuDNN runs f32 convs in TF32 unless told not to,
which would break parity at the third digit, so :func:`resolve_device` turns
TF32 off for both cuDNN and cuBLAS whenever it hands out a CUDA device.

The JAX package's second mode, ``precision_name="default"`` of its streaming
and batch engines, is TF32 here. It is a scoped choice, not a process-wide
one: :func:`conv_precision` sets the two flags around one forward and puts
them back, so a parity click and a streaming step live in one process. A
captured CUDA graph keeps the kernels chosen while it was captured, so a
graph's mode is the one its capture ran under.
"""

from __future__ import annotations

import contextlib

import torch

# precision_name -> may cuDNN and cuBLAS take TF32 for f32 inputs
_TF32 = {"highest": False, "default": True}


def set_parity_mode() -> None:
    """Full f32 for convs (cuDNN) and matrix products (cuBLAS)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def conv_precision(name: str):
    """Scope of one forward at ``name``: "highest" (full f32, the parity
    mode) or "default" (cuDNN and cuBLAS may take TF32, the counterpart of
    the JAX package's ``Precision.DEFAULT``). The flags are process-wide in
    PyTorch; they are restored on the way out. No effect on the CPU."""
    tf32 = _TF32[name]
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device. Raises when a CUDA device is
    asked for (or defaulted to) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        set_parity_mode()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
