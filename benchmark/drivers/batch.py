"""Bulk batches, closed loop, one client: each action sends ``batch``
seeded square uint8 images, each with a seeded hint table of 0 to
``max_hints`` live hints (0 is automatic colorization), and takes the
frames back as numpy.

The images come from a pool of ``pool_batches`` batches made on the
device in set-up and copied to the host once; action ``i`` sends batch
``i % pool_batches`` with a table drawn for the action, so every seed
sends the same number of images of the same size. The check compares the
frames of every action that the seeded sample picked with the plain
reference in float32 (at most ``samples_per_s_max`` a second of the
window, copied into slots allocated in set-up)."""

from __future__ import annotations

import math

import numpy as np
import torch

from harness import check, inputs
from harness.store import Store
from reference import color, hints


class Driver:
    def __init__(self, cell, model, entry, seed: int, device, fault=None):
        self.cfg, self.mix = cell.config, cell.mix
        self.model, self.entry = model, entry
        self.seed, self.device, self.fault = seed, device, fault
        self.S = self.mix.get("size", self.cfg["Xd"])
        self.N = self.mix["batch"]
        self.flops = model.flops(self.cfg, self.S)
        self._prev = None
        self.mark = lambda what: None

    def prepare(self, seconds: float, warm_profiler: bool = False) -> None:
        P = self.mix["pool_batches"]
        pool = inputs.images_device(self.seed, P * self.N, self.S, torch,
                                    self.device)
        self.pool = pool.cpu().numpy().reshape(P, self.N, self.S, self.S, 3)
        del pool
        self.mark("image pool")
        self.sess = self.entry.Session(self.cfg, self.cfg["weights"]["file"],
                                       self.device)
        self.mark("session open")
        warm = inputs.rng(self.seed, "warmup")
        for i in range(self.mix["warmup_actions"]):
            frames = self.call(self._inputs(i, warm))
        self.mark("warm-up")
        self.kept = Store(math.ceil(seconds * self.mix["samples_per_s_max"]),
                          {"frames": frames})
        self.mark("sample store")
        if warm_profiler:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                self.call(self._inputs(0, warm))
        self.tables = inputs.rng(self.seed, "tables")
        self.sample = inputs.rng(self.seed, "sample")
        self._prev = None

    def _inputs(self, i: int, r: np.random.Generator) -> dict:
        mix, N, M, S = self.mix, self.N, self.mix["max_hints"], self.S
        counts = r.integers(0, M + 1, N).astype(np.int32)
        lo, hi = mix["half_width"]
        rad = r.integers(lo, hi + 1, (N, M))
        y = np.clip(r.integers(0, S, (N, M)), rad, S - 1 - rad)
        x = np.clip(r.integers(0, S, (N, M)), rad, S - 1 - rad)
        boxes = np.stack([y - rad, x - rad, y + rad, x + rad], -1).astype(
            np.int32)
        values = r.uniform(-mix["ab_max"], mix["ab_max"], (N, M, 2)).astype(
            np.float32)
        return {"pool": i % mix["pool_batches"], "boxes": boxes,
                "values": values, "counts": counts}

    def inputs(self, i: int) -> dict:
        return self._inputs(i, self.tables)

    def call(self, inp):
        out = self.sess.call(self.pool[inp["pool"]], inp["boxes"],
                             inp["values"], inp["counts"])
        if self.fault == "stale":
            out, self._prev = (self._prev if self._prev is not None
                               else out), out
        elif self.fault == "half":
            out = out.copy()
            out[self.N // 2:] = out[: self.N - self.N // 2]
        elif self.fault == "altered":
            out = out.copy()
            out[0, : self.S // 4] = 255 - out[0, : self.S // 4]
        return out

    def units(self, inp) -> int:
        return self.N

    def after(self, i, inp, out) -> None:
        picked = self.sample.random() < 1.0 / self.mix["sample_every"]
        if picked and out is not None and not self.kept.full():
            self.kept.put(inp, frames=out)

    def work(self, inp) -> dict:
        return {"tables": [int(c) for c in inp["counts"]], "size": self.S,
                "k2_batch_frames": self.N, "flops": self.N * self.flops,
                "images": self.N}

    def close(self) -> None:
        self.sess.close()
        del self.sess

    # ----- the check -----
    def reference(self, kept: list[dict], prec: str, w=None) -> list:
        """Reference frames, image by image in blocks, for ``kept``."""
        w = w if w is not None else self.model.load_weights(
            self.cfg, self.seed, self.device)
        frames = []
        block = self.mix.get("check_block", 16)
        items = [(k["pool"], j, k) for k in kept for j in range(self.N)]
        for s in range(0, len(items), block):
            part = items[s:s + block]
            img = torch.from_numpy(np.stack([self.pool[p][j] for p, j, _k
                                             in part])).to(self.device)
            # the batch engine's L: Lab of the /255 image, centered by 50
            # and restored, as the engine hands it on
            l_raw = ((color.rgb_to_lab(img.to(torch.float32) / 255.0)
                      [..., 0] - 50.0) + 50.0)[:, None]
            planes = [hints.rasterize(k["boxes"][j], k["values"][j],
                                      int(k["counts"][j]), self.S)
                      for _p, j, k in part]
            ab = torch.from_numpy(np.stack([q[0] for q in planes])).to(
                self.device)
            mask = torch.from_numpy(np.stack([q[1] for q in planes])).to(
                self.device)
            with torch.no_grad():
                pred = self.model.reference(w, self.cfg, l_raw, ab, mask,
                                            prec)["pred"]
                rgb = color.lab_to_rgb_u8(l_raw[:, 0], pred[:, 0], pred[:, 1])
            frames += list(rgb.cpu().numpy())
        return frames

    def check(self, limits: dict) -> tuple[bool, dict]:
        tally = check.Tally(limits)
        w = self.model.load_weights(self.cfg, self.seed, self.device)
        for j, inp in enumerate(self.kept.meta):
            ref = self.reference([inp], "float32", w)
            tally.add({"frame": list(self.kept.get("frames", j))},
                      {"frame": ref}, 1)
        return tally.result(limits)

    def control(self, n_actions: int, prec: str, limits: dict) -> dict:
        """The check with the reference at ``prec`` in the program's place,
        over the batches a run of ``n_actions`` actions samples."""
        P = self.mix["pool_batches"]
        self.pool = inputs.images_device(
            self.seed, P * self.N, self.S, torch, self.device).cpu().numpy(
            ).reshape(P, self.N, self.S, self.S, 3)
        w = self.model.load_weights(self.cfg, self.seed, self.device)
        tables = inputs.rng(self.seed, "tables")
        sample = inputs.rng(self.seed, "sample")
        tally = check.Tally(limits)
        for i in range(n_actions):
            inp = self._inputs(i, tables)
            if sample.random() < 1.0 / self.mix["sample_every"]:
                low = self.reference([inp], prec, w)
                ref = self.reference([inp], "float32", w)
                tally.add({"frame": low}, {"frame": ref}, 1)
        return tally.result(limits)[1]
