"""Global color-statistics extractor (histogram-transfer conditioning).

Counterpart of ``ideepcolor_tpu/models/global_stats.py``, which replaces the
reference's weightless Caffe graph ``global_stats.prototxt``:

  rgb -> Lab -> ab 4x4 average pool -> soft-encode to 313 bins (NN=1: the
  hard one-hot of the nearest bin) -> global average -> ``glob_ab_313``;
  plus the mean HSV saturation and the BGR channel means.

The reference's dropout keep-flags are always 1 at inference, so the raw
statistics are returned. The chain is torch ops on the device the image is
on (or is sent to).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import colorspace as cs
from ..ops.quantize import soft_encode
from ..utils.profiling import spanned


@spanned("glob.stats")
@torch.no_grad()
def extract(rgb, device=None) -> dict[str, torch.Tensor]:
    """rgb: (H, W, 3) float in [0, 1], H and W divisible by 4; a tensor
    (used where it lies) or a numpy array (sent to ``device``: the card
    unless ``device="cpu"``).

    Returns tensors on that device:
      glob_ab_313: (313,) global ab histogram, the blob the notebook feeds
                   the global net,
      s_avg:       () mean HSV saturation,
      bgr_avg:     (3,) channel means in BGR order.
    """
    if not isinstance(rgb, torch.Tensor):
        rgb = torch.as_tensor(np.ascontiguousarray(rgb, np.float32),
                              device=resolve_device(device))
    rgb = rgb.to(torch.float32)
    ab = cs.rgb_to_lab(rgb)[..., 1:]
    h, w = ab.shape[0], ab.shape[1]
    ab_rs = ab.reshape(h // 4, 4, w // 4, 4, 2).mean(dim=(1, 3))
    glob = soft_encode(ab_rs, nn=1).mean(dim=(0, 1))
    s_avg = cs.rgb_to_hsv(rgb)[..., 1].mean()
    bgr_avg = rgb.mean(dim=(0, 1)).flip(0)
    return {"glob_ab_313": glob, "s_avg": s_avg, "bgr_avg": bgr_avg}
