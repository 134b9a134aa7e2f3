"""Global color-statistics extractor (histogram-transfer conditioning).

Counterpart of ``ideepcolor_tpu/models/global_stats.py``, which replaces the
reference's weightless Caffe graph ``global_stats.prototxt``:

  rgb -> Lab -> ab 4x4 average pool -> soft-encode to 313 bins (NN=1: the
  hard one-hot of the nearest bin) -> global average -> ``glob_ab_313``;
  plus the mean HSV saturation and the BGR channel means.

The reference's dropout keep-flags are always 1 at inference, so the raw
statistics are returned. On the card the whole extraction is kernel K3
(``ops/cuda/global_stats_kernel.py``: two launches, the bin centers
uploaded once per device); on the CPU it is K3's plain version, the chain
of torch ops. The two differ only where a pooled pixel lies within rounding
of a bin boundary: K3 takes the direct distance to each bin center, the
chain its product expansion.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda import global_stats_kernel as k3
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
    if rgb.device.type != "cpu":
        rgb = rgb.contiguous()          # K3 reads whole rows
    glob, s_avg, bgr_avg = k3.global_stats(rgb)
    return {"glob_ab_313": glob, "s_avg": s_avg, "bgr_avg": bgr_avg}
