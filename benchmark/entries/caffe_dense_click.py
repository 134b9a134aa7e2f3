"""``ColorizeImageTorchCaffeDist.net_forward``: the Caffe distribution
graph's dense click, the reference application's contract (dense (2,S,S)
hint ab and (1,S,S) mask in, the frame read back; the distribution map
stays on the device). One captured graph: trunk, hypercolumn head, two
upsamplers, two softmaxes, the annealed mean, K2's fused entry."""

from __future__ import annotations

import numpy as np

K1_TABLES = False         # the hints arrive rasterized
K2_FUSED_FRAMES = 1


class Session:
    def __init__(self, cfg: dict, image: np.ndarray, weights, device):
        from ideepcolor_tpu_torch.api.colorize import (
            ColorizeImageTorchCaffeDist)
        self.m = ColorizeImageTorchCaffeDist(Xd=cfg["Xd"], device=device)
        self.m.prep_net(S=cfg["scale_S"])
        # the benchmark's weights, drawn from the seed, in the program's
        # own state dict layout
        self.m.net.load_state_dict(weights, strict=True)
        self.m.load_image_array(image)

    def call(self, ab, mask):
        out = self.m.net_forward(ab, mask)
        return None if isinstance(out, int) else out

    def answer(self, want_map: bool) -> dict:
        """The click's outputs besides the frame, where the program holds
        them (no copy): ``output_ab`` as (S, S, 2) and, if asked, the
        distribution map as (S, S, 313)."""
        out = {"ab": self.m._dev_output_ab}
        if want_map:
            out["map"] = self.m._dev_dist
        return out

    def close(self):
        del self.m
