"""``ColorizeImageTorchDist``: the SIGGRAPH net's distribution session, as
the reference application's GUI runs it. A predicting action rasterizes
the new hint table with K1 and predicts the (Xd/4, Xd/4, 529) map on the
device (``predict_dist_table``, one captured graph: K1 and the dist
forward); every action then asks for K suggestions at a pixel
(``get_ab_reccs``, one captured graph per (K, N): the pdf's gather, the
inverse-CMF sampling, k-means++ seeding and Lloyd over the restarts, the
sort), whose centers and confidences are read back. The map and the
chain's uniform numbers stay on the device, where the check reads them
after the timed call."""

from __future__ import annotations

import numpy as np


class Session:
    def __init__(self, cfg: dict, image: np.ndarray, weights, device):
        from ideepcolor_tpu_torch.api.colorize import ColorizeImageTorchDist
        self.m = ColorizeImageTorchDist(Xd=cfg["Xd"], device=device)
        if not hasattr(self.m, "_dev_draws"):
            raise RuntimeError(
                "this program keeps no draws of its suggestions "
                "(ColorizeImageTorchDist._dev_draws); the check of this "
                "cell works each palette out again from them")
        self.m.prep_net(path=cfg["weights"]["file"])
        self.m.load_image_array(image)
        self.K, self.N = cfg["suggest"]["K"], cfg["suggest"]["N"]
        self.div = cfg["map_div"]
        if self.m.dist_map_div != self.div:
            raise ValueError(f"the program keeps its map at 1/"
                             f"{self.m.dist_map_div}, the configuration "
                             f"says 1/{self.div}")

    def predict(self, boxes, values, count) -> bool:
        return self.m.predict_dist_table(boxes, values, count) == 0

    def suggest(self, h: int, w: int):
        out = self.m.get_ab_reccs(h, w, K=self.K, N=self.N, return_conf=True)
        return None if isinstance(out, int) else out

    def answer(self, h: int, w: int) -> dict:
        """The program's state after an action, where it holds it (no
        copy): the pdf at pixel (h, w) of its map, the map, and the uniform
        numbers of its newest suggestion."""
        u_bins, u_seeds = self.m._dev_draws
        dist = self.m._dev_dist
        return {"pdf": dist[h // self.div, w // self.div], "map": dist,
                "u_bins": u_bins, "u_seeds": u_seeds}

    def close(self):
        del self.m
