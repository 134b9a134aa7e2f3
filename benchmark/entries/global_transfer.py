"""Histogram transfer through ``ColorizeImageTorchCaffeGlobDist``, the
sequence of the port's notebook ``DemoGlobalHistogramTransfer`` and of the
server's ``/colorize_global``: a uint8 RGB reference goes up,
``resize_u8_half_pixel`` to Xd x Xd on the card, ``/ 255``,
``global_stats.extract``, ``glob_ab_313`` read back to the host, then the
global graph's dense click with zero hint planes and that histogram (one
captured graph: trunk, MLP, regression head, K2's fused entry), the frame
read back."""

from __future__ import annotations

import numpy as np
import torch

K2_FUSED_FRAMES = 1


class Session:
    def __init__(self, cfg: dict, image: np.ndarray, weights, device):
        from ideepcolor_tpu_torch.api.colorize import (
            ColorizeImageTorchCaffeGlobDist)
        from ideepcolor_tpu_torch.models import global_stats
        from ideepcolor_tpu_torch.ops.resize import resize_u8_half_pixel
        self._extract, self._resize = global_stats.extract, \
            resize_u8_half_pixel
        self.S, self.device = cfg["Xd"], device
        self.m = ColorizeImageTorchCaffeGlobDist(Xd=self.S, device=device)
        self.m.prep_net()
        # the benchmark's weights, drawn from the seed, in the program's
        # own state dict layout
        self.m.net.load_state_dict(weights, strict=True)
        self.m.load_image_array(image)
        # no local hints: the global graph's hint channels feed no layer
        self.ab = np.zeros((2, self.S, self.S), np.float32)
        self.mask = np.zeros((1, self.S, self.S), np.float32)
        self.hist = None

    def call(self, ref: np.ndarray):
        small = self._resize(torch.as_tensor(ref, device=self.device),
                             (self.S, self.S))
        stats = self._extract(small.to(torch.float32) / 255.0)
        self.hist = stats["glob_ab_313"].cpu().numpy()
        out = self.m.net_forward(self.ab, self.mask, self.hist)
        return None if isinstance(out, int) else out

    def answer(self) -> dict:
        """The action's outputs besides the frame, where the program holds
        them (no copy): ``output_ab`` as (S, S, 2) and the (313,) histogram
        the click was given."""
        return {"ab": self.m._dev_output_ab, "hist": self.hist}

    def close(self):
        del self.m
