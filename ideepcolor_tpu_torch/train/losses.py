"""Training losses: smooth-L1 on ab, cross-entropy against soft-encoded ab
bins, PSNR.

Counterpart of ``ideepcolor_tpu/train/losses.py``. Logits and targets are
NCHW here (channel-last in the JAX package).
"""

from __future__ import annotations

import torch

from ..ops.quantize import soft_encode


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              delta: float = 1.0) -> torch.Tensor:
    """Huber loss, mean over all elements (callers divide ab by 110 so that
    ``delta=1`` means something)."""
    d = (pred - target).abs()
    return torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta).mean()


def class_xent(logits: torch.Tensor, target_ab: torch.Tensor,
               centers: torch.Tensor, nn: int = 10,
               sigma: float = 5.0) -> torch.Tensor:
    """Cross-entropy of bin logits (N,Q,H,W) against the soft encoding of
    target ab (N,2,H,W): the ``nn`` nearest of the Q ``centers``, RBF
    weights of width ``sigma`` (the NNEncLayer's NN=10, sigma=5)."""
    q = soft_encode(target_ab.movedim(1, -1), centers=centers, nn=nn,
                    sigma=sigma)
    logp = torch.log_softmax(logits, dim=1).movedim(1, -1)
    return -(q * logp).sum(-1).mean()


def psnr(pred_rgb: torch.Tensor, target_rgb: torch.Tensor,
         max_val: float = 255.0) -> torch.Tensor:
    """PSNR over the whole tensor (the reference's ``get_result_PSNR``)."""
    mse = ((pred_rgb.to(torch.float32) - target_rgb.to(torch.float32))
           ** 2).mean()
    return 20.0 * torch.log10(max_val / torch.sqrt(mse))
