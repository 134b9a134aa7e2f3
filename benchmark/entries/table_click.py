"""``ColorizeImageTorch.net_forward_table``: the SIGGRAPH net's table
click (K1 -> U-Net in float32 -> K2's fused entry, one captured graph),
the frame read back. ``output_ab`` is taken after the timed call, for
the check only."""

from __future__ import annotations

import numpy as np

K1_TABLES = True          # the action's hint table goes through K1
K2_FUSED_FRAMES = 1       # frames per action through K2's fused entry


class Session:
    def __init__(self, cfg: dict, image: np.ndarray, weights, device):
        from ideepcolor_tpu_torch.api.colorize import ColorizeImageTorch
        self.m = ColorizeImageTorch(Xd=cfg["Xd"], device=device)
        self.m.prep_net(path=cfg["weights"]["file"])
        self.m.load_image_array(image)

    def call(self, boxes, values, count):
        out = self.m.net_forward_table(boxes, values, count)
        return None if isinstance(out, int) else out

    def answer(self, want_map: bool) -> dict:
        """The click's outputs besides the frame, where the program holds
        them (no copy): ``output_ab`` as (S, S, 2)."""
        return {"ab": self.m._dev_output_ab}

    def close(self):
        del self.m
