"""A drag of hints over one image, closed loop, one client.

One seeded image is loaded in set-up. Action ``i`` adds a hint when ``i``
is a multiple of ``new_hint_every`` (the table starts again from one hint
once it holds ``max_hints``) and otherwise moves the newest hint by a few
pixels, so the live count at action ``i`` is the same on every seed. A
hint's box half-width, position, move and ab come from the seed. The
entry gets the table, or dense planes rasterized from it where the mix
says ``"hints": "dense"``. Actions follow each other with no think time:
a dragging user's moves queue up once a click is slower than the mouse.

The check compares, once the window has closed, every action that the
seeded sample picked (one in ``sample_every``, past the first
``trace_actions``, at most ``samples_per_s_max`` a second of the window)
with the configuration's plain reference, computed from the same image,
table and weights. A picked answer is copied into slots allocated in
set-up (``harness.store``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from harness import check, inputs
from harness.store import Store
from reference import color, hints, resize


class Script:
    """The seeded drag: ``next()`` gives action after action's table."""

    def __init__(self, r: np.random.Generator, size: int, mix: dict):
        self.r, self.S, self.mix = r, size, mix
        self.live: list[list] = []
        self.i = 0

    def _clamp(self, v: int, rad: int) -> int:
        return int(min(max(v, rad), self.S - 1 - rad))

    def next(self):
        mix, r = self.mix, self.r
        if self.i % mix["new_hint_every"] == 0:
            if len(self.live) == mix["max_hints"]:
                self.live = []
            lo, hi = mix["half_width"]
            rad = int(r.integers(lo, hi + 1))
            y, x = (self._clamp(int(v), rad) for v in r.integers(0, self.S, 2))
            a, b = r.uniform(-mix["ab_max"], mix["ab_max"], 2)
            self.live.append([y, x, rad, a, b])
        else:
            h = self.live[-1]
            dy, dx = r.integers(-mix["move_px"], mix["move_px"] + 1, 2)
            h[0], h[1] = self._clamp(h[0] + dy, h[2]), self._clamp(h[1] + dx,
                                                                   h[2])
        self.i += 1
        n = mix["max_hints"]
        boxes = np.zeros((n, 4), np.int32)
        values = np.zeros((n, 2), np.float32)
        for k, (y, x, rad, a, b) in enumerate(self.live):
            boxes[k] = (y - rad, x - rad, y + rad, x + rad)
            values[k] = (a, b)
        return boxes, values, len(self.live)


class Driver:
    def __init__(self, cell, model, entry, seed: int, device, fault=None):
        self.cfg, self.mix = cell.config, cell.mix
        self.model, self.entry = model, entry
        self.seed, self.device, self.fault = seed, device, fault
        self.S = self.cfg["Xd"]
        self.dense = self.mix.get("hints") == "dense"
        self.flops = model.flops(self.cfg, self.S)
        self._prev = None
        self.mark = lambda what: None

    def prepare(self, seconds: float, warm_profiler: bool = False) -> None:
        H, W = self.mix["image_hw"]
        self.image = inputs.image(inputs.rng(self.seed, "image"), H, W)
        w = None
        if "seeded" in self.cfg["weights"]:
            w = self.model.load_weights(self.cfg, self.seed, self.device)
        self.mark("image and weights")
        self.sess = self.entry.Session(self.cfg, self.image, w, self.device)
        self.mark("session open")
        # the weights the reference will take: the bytes the program got
        self.w_host = None if w is None else {k: v.cpu() for k, v in
                                              w.items()}
        del w
        warm = Script(inputs.rng(self.seed, "warmup"), self.S, self.mix)
        for _ in range(self.mix["warmup_actions"]):
            frame = self.call(self.inputs(None, warm))
        self.mark("warm-up")
        # slots for the sampled answers, and for the first ``map_samples``
        # of them their distribution maps
        ans = self.sess.answer(want_map=True)
        self.kept = Store(math.ceil(seconds * self.mix["samples_per_s_max"]),
                          {"frame": frame, "ab": ans["ab"]})
        self.maps = Store(self.mix.get("map_samples", 0) if "map" in ans
                          else 0, {"map": ans.get("map", frame)})
        del ans
        self.mark("sample store")
        if warm_profiler:                    # the profiler's own start-up
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                self.call(self.inputs(None, warm))
        self.script = Script(inputs.rng(self.seed, "script"), self.S,
                             self.mix)
        self.sample = inputs.rng(self.seed, "sample")
        self._prev = None

    def inputs(self, i, script=None) -> dict:
        table = (script or self.script).next()
        if self.dense:
            ab, mask = hints.rasterize(*table, self.S)
            return {"table": table, "args": (ab, mask)}
        return {"table": table, "args": table}

    def call(self, inp):
        out = self.sess.call(*inp["args"])
        if self.fault == "stale" and out is not None:
            out, self._prev = (self._prev if self._prev is not None
                               else out), out
        elif self.fault == "altered" and out is not None:
            out = out.copy()
            out[: self.S // 4] = 255 - out[: self.S // 4]
        return out

    def units(self, inp) -> int:
        return 1

    def after(self, i, inp, out) -> None:
        # the sample is drawn past the actions a traced run profiles, so
        # that the check's readbacks stay out of the trace
        picked = self.sample.random() < 1.0 / self.mix["sample_every"]
        if (not picked or out is None or i < self.mix["trace_actions"]
                or self.kept.full()):
            return
        ans = self.sess.answer(want_map=not self.maps.full())
        j = self.kept.put(inp["table"], frame=out, ab=ans["ab"])
        if "map" in ans:
            self.maps.put(j, map=ans["map"])

    def work(self, inp) -> dict:
        return {"tables": [inp["table"][2]] if self.entry.K1_TABLES else [],
                "size": self.S, "k2_fused_frames": self.entry.K2_FUSED_FRAMES,
                "flops": self.flops, "images": 1}

    def close(self) -> None:
        self.sess.close()
        del self.sess

    # ----- the check -----
    def l_plane(self) -> torch.Tensor:
        """(1, 1, S, S) L of the net-size image, worked out again."""
        small = resize.resize_u8(torch.from_numpy(self.image), self.S, self.S)
        lab = color.rgb_to_lab(small.to(self.device).to(torch.float32)
                               / 255.0)
        return lab[None, None, ..., 0]

    def reference(self, tables, prec: str, w=None) -> dict:
        """The reference's outputs for ``tables`` at ``prec``, in blocks."""
        w = w if w is not None else self.weights()
        l = self.l_plane()
        out = {"frame": [], "ab": [], "map": []}
        block = self.mix.get("check_block", 8)
        for s in range(0, len(tables), block):
            planes = [hints.rasterize(*t, self.S) for t in tables[s:s + block]]
            ab = torch.from_numpy(np.stack([p[0] for p in planes])).to(
                self.device)
            mask = torch.from_numpy(np.stack([p[1] for p in planes])).to(
                self.device)
            with torch.no_grad():
                r = self.model.reference(w, self.cfg, l.expand(len(planes),
                                                               -1, -1, -1),
                                         ab, mask, prec)
                frames = color.lab_to_rgb_u8(l[:, 0], r["pred"][:, 0],
                                             r["pred"][:, 1])
                fab = color.frame_ab(frames)
            out["frame"] += list(frames.cpu().numpy())
            out["ab"] += list(fab.cpu().numpy())
            if "map" in r:
                out["map"] += list(r["map"].cpu().numpy())
        return out

    def weights(self) -> dict:
        if self.w_host is not None:
            return {k: v.to(self.device) for k, v in self.w_host.items()}
        return self.model.load_weights(self.cfg, self.seed, self.device)

    def check(self, limits: dict) -> tuple[bool, dict]:
        tally = check.Tally(limits)
        w = self.weights()
        kept, maps = self.kept, self.maps
        map_of = {j: m for m, j in enumerate(maps.meta)}
        block = self.mix.get("check_block", 8)
        for s in range(0, len(kept), block):
            part = range(s, min(s + block, len(kept)))
            ref = self.reference([kept.meta[j] for j in part], "float32", w)
            port = {"frame": [kept.get("frame", j) for j in part],
                    "ab": [kept.get("ab", j) for j in part]}
            with_map = [j - s for j in part if j in map_of]
            port["map"] = [maps.get("map", map_of[s + j]) for j in with_map]
            ref["map"] = [ref["map"][j] for j in with_map] if ref["map"] \
                else []
            if not with_map:
                port.pop("map"), ref.pop("map")
            tally.add(port, ref, len(part))
        return tally.result(limits)

    def control(self, n_actions: int, prec: str, limits: dict) -> dict:
        """The check with the reference at ``prec`` put in the program's
        place: the same image, weights and sampled tables as a run of
        ``n_actions`` actions, compared with the float32 reference. No
        program runs."""
        H, W = self.mix["image_hw"]
        self.image = inputs.image(inputs.rng(self.seed, "image"), H, W)
        self.w_host = None
        w = self.model.load_weights(self.cfg, self.seed, self.device)
        script = Script(inputs.rng(self.seed, "script"), self.S, self.mix)
        sample = inputs.rng(self.seed, "sample")
        tables = []
        for i in range(n_actions):
            t = script.next()
            if (sample.random() < 1.0 / self.mix["sample_every"]
                    and i >= self.mix["trace_actions"]):
                tables.append(t)
        tally = check.Tally(limits)
        maps = self.mix.get("map_samples", 0)
        block = self.mix.get("check_block", 8)
        for s in range(0, len(tables), block):
            part = tables[s:s + block]
            low = self.reference(part, prec, w)
            ref = self.reference(part, "float32", w)
            keep = max(0, min(len(part), maps - s))
            for d in (low, ref):
                d["map"] = d["map"][:keep]
                if not d["map"]:
                    d.pop("map")
            tally.add(low, ref, len(part))
        return tally.result(limits)[1]
