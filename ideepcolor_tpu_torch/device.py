"""Device choice and the f32 parity rule for the port's entry points.

Entry points run on the card unless the caller asks for the CPU with
``device="cpu"``. Without a usable card, a call that did not ask for the CPU
raises; it never quietly runs on the CPU.

Parity mode is f32: the JAX package runs its convs and resize contractions
at ``Precision.HIGHEST``. cuDNN runs f32 convs in TF32 unless told not to,
which would break parity at the third digit, so :func:`resolve_device` turns
TF32 off for both cuDNN and cuBLAS whenever it hands out a CUDA device.
"""

from __future__ import annotations

import torch


def set_parity_mode() -> None:
    """Full f32 for convs (cuDNN) and matrix products (cuBLAS)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


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
