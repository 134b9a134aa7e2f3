"""``engine.batch.colorize_batch_table``: the bulk tier. N uint8 images
and N hint tables in, N frames out as numpy: K1's batched entry, one
U-Net forward at TF32, K2's batched compose; eager, no captured graph."""

from __future__ import annotations


class Session:
    def __init__(self, cfg: dict, weights_file: str, device):
        from ideepcolor_tpu_torch.engine.batch import colorize_batch_table
        from ideepcolor_tpu_torch.models.siggraph import (
            SIGGRAPHGenerator, load_state_dict_file)
        self._fn = colorize_batch_table
        self.net = SIGGRAPHGenerator.from_state_dict(
            load_state_dict_file(weights_file)).to(device).requires_grad_(
                False)
        self.device = device

    def call(self, images, boxes, values, counts):
        return self._fn(self.net, images, boxes, values, counts,
                        device=self.device)

    def close(self):
        del self.net
