"""Color suggestions probed over one image, closed loop, one client.

One seeded image is loaded in set-up. Action ``i`` is a predicting action
when ``i`` is a multiple of ``predict_every``: the seeded drag script of
``drivers.drag`` adds a hint to the table (1 to ``max_hints`` live, then
from one again), the entry predicts the distribution map from the new
table and suggests colors at the new hint's pixel. Every other action is a
probe: the entry suggests colors at a seeded pixel, uniform over the net's
grid, on the map it holds. Every action ends with the palette in host
memory. Actions follow each other with no think time, as a user hovering
over the image for suggestions does.

The check compares, once the window has closed, every action that the
seeded sample picked (one in ``sample_every``, past the first
``trace_actions``, at most ``samples_per_s_max`` a second of the window)
with the configuration's plain references. For each, after the action, the
program's pdf at the probed pixel and the uniform numbers its chain drew
are copied into slots allocated in set-up (``harness.store``), and for the
first ``map_samples`` the whole map:

- ``map_err_max``: the largest absolute difference of a probability
  between the program's pdf (and whole maps) and the float32 reference
  map of the table in effect;
- ``center_err_max`` and ``conf_err_max``: the largest difference of an
  ab center and of a cluster's share between the palette and the
  reference chain given the program's own pdf and draws, as the global
  cell holds its frame given the program's histogram.

Ties. The chain's choices are exact in the program's float32 but for
three, which the check does not read as faults: a seeding draw within
float32 rounding of the boundary between two bins (the reference follows
both seeds), two restarts whose inertias are equal within rounding (each
is a palette the program may give), and two clusters of equal occupancy,
whose order the sort leaves to the restart (a center is held to the
nearest center of the same occupancy). The palette is compared with the
nearest of the palettes the reference allows. Everything else (the draws'
bins, the seeds' distances, each Lloyd step's sums of integer counts) the
program and the reference compute exactly, so a palette at the wrong
pixel, from other draws or from a stale map comes out far off."""

from __future__ import annotations

import math

import numpy as np
import torch

from drivers.drag import Script
from harness import check, inputs
from harness.store import Store
from reference import color, hints, resize

CHAIN_NUMBERS = ("center_err_max", "conf_err_max")


class Actions:
    """The seeded actions: ``next(i)`` gives action ``i``'s new table (or
    None on a probe), the table in effect and the pixel (h, w)."""

    def __init__(self, r: np.random.Generator, size: int, mix: dict):
        self.r, self.S, self.every = r, size, mix["predict_every"]
        # every step of the script adds a hint
        self.script = Script(r, size, {
            "new_hint_every": 1, "max_hints": mix["max_hints"],
            "half_width": mix["half_width"], "ab_max": mix["ab_max"]})
        self.table = None

    def next(self, i: int):
        if i % self.every == 0:
            self.table = self.script.next()
            y, x, _rad, _a, _b = self.script.live[-1]
            return self.table, self.table, (int(y), int(x))
        h, w = (int(v) for v in self.r.integers(0, self.S, 2))
        return None, self.table, (h, w)


def palette_errors(port_c, port_conf, candidates) -> tuple[float, float]:
    """(center error, share error) of one palette against the nearest of
    the reference's candidates: each center held to the nearest center of
    the same occupancy, each share to the share in its place."""
    best = (math.inf, math.inf)
    for c, conf, mass in candidates:
        ce = 0.0
        for k in range(len(c)):
            tie = mass == mass[k]
            ce = max(ce, float(np.abs(c[tie] - port_c[k]).max(1).min()))
        best = min(best, (ce, float(np.abs(conf - port_conf).max())))
    return best


class Driver:
    def __init__(self, cell, model, entry, seed: int, device, fault=None):
        self.cfg, self.mix = cell.config, cell.mix
        self.model, self.entry = model, entry
        self.seed, self.device, self.fault = seed, device, fault
        self.S = self.cfg["Xd"]
        self.div = self.cfg["map_div"]
        self.sugg = self.cfg["suggest"]
        self.flops = model.flops(self.cfg, self.S)
        self.mark = lambda what: None

    def prepare(self, seconds: float, warm_profiler: bool = False) -> None:
        H, W = self.mix["image_hw"]
        self.image = inputs.image(inputs.rng(self.seed, "image"), H, W)
        self.mark("image")
        self.sess = self.entry.Session(self.cfg, self.image, None,
                                       self.device)
        self.mark("session open")
        warm = Actions(inputs.rng(self.seed, "warmup"), self.S, self.mix)
        for i in range(self.mix["warmup_actions"]):
            out = self.call(self._inputs(i, warm))
        self.mark("warm-up")
        ans = self.sess.answer(0, 0)
        self.kept = Store(math.ceil(seconds * self.mix["samples_per_s_max"]),
                          {"centers": out[0], "conf": out[1],
                           "pdf": ans["pdf"], "u_bins": ans["u_bins"],
                           "u_seeds": ans["u_seeds"]})
        self.maps = Store(self.mix["map_samples"], {"map": ans["map"]})
        del ans
        self.mark("sample store")
        if warm_profiler:                    # the profiler's own start-up
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                self.call(self._inputs(self.mix["warmup_actions"], warm))
        self.actions = Actions(inputs.rng(self.seed, "script"), self.S,
                               self.mix)
        self.sample = inputs.rng(self.seed, "sample")

    def _inputs(self, i, actions) -> dict:
        new, table, (h, w) = actions.next(i)
        at = (h, w)
        if self.fault == "wrong_pixel":      # the probe is made elsewhere
            at = ((h + self.S // 2) % self.S, w)
        return {"new": new, "table": table, "pixel": (h, w), "at": at}

    def inputs(self, i) -> dict:
        inp = self._inputs(i, self.actions)
        if self.fault == "stale_map":        # the map is never predicted
            inp["new"] = None                # again in the window
        return inp

    def call(self, inp):
        if inp["new"] is not None and not self.sess.predict(*inp["new"]):
            return None
        return self.sess.suggest(*inp["at"])

    def units(self, inp) -> int:
        return 1

    def after(self, i, inp, out) -> None:
        # the sample is drawn past the actions a traced run profiles, so
        # that the check's readbacks stay out of the trace
        picked = self.sample.random() < 1.0 / self.mix["sample_every"]
        if (not picked or out is None or i < self.mix["trace_actions"]
                or self.kept.full()):
            return
        ans = self.sess.answer(*inp["pixel"])
        u_bins = ans["u_bins"]
        if self.fault == "altered_draws":    # other draws than the chain's
            u_bins = torch.remainder(u_bins + 0.5, 1.0)
        j = self.kept.put((inp["table"], inp["pixel"]), centers=out[0],
                          conf=out[1], pdf=ans["pdf"], u_bins=u_bins,
                          u_seeds=ans["u_seeds"])
        if not self.maps.full():
            self.maps.put(j, map=ans["map"])

    def work(self, inp) -> dict:
        return {"flops": self.flops if inp["new"] is not None else 0.0}

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

    def ref_pdfs(self, metas, prec: str, w: dict, whole: int) -> list:
        """For each (table, (h, w)) of ``metas`` the reference's pdf at the
        pixel's map pixel at ``prec``, and for the first ``whole`` the
        whole (S/4, S/4, bins) map after it, as numpy: one forward per
        distinct table, in blocks."""
        l = self.l_plane()
        tables = list({id(t): t for t, _px in metas}.values())
        out = [None] * len(metas)
        block = self.mix["check_block"]
        for s in range(0, len(tables), block):
            part = tables[s:s + block]
            planes = [hints.rasterize(*t, self.S) for t in part]
            ab = torch.from_numpy(np.stack([p[0] for p in planes])).to(
                self.device)
            mask = torch.from_numpy(np.stack([p[1] for p in planes])).to(
                self.device)
            with torch.no_grad():
                maps = self.model.reference(
                    w, self.cfg, l.expand(len(planes), -1, -1, -1), ab, mask,
                    prec)["map"]
            at = {id(t): k for k, t in enumerate(part)}
            for j, (t, (h, wx)) in enumerate(metas):
                if id(t) in at:
                    m = maps[at[id(t)]]
                    out[j] = [m[h // self.div, wx // self.div].cpu().numpy()]
                    if j < whole:
                        out[j].append(m.cpu().numpy())
        return out

    def _palette_numbers(self, samples, prec) -> tuple[float, float]:
        """Worst (center, share) errors of (centers, conf, pdf, u_bins,
        u_seeds) samples against the reference chain at float32, the chain
        at ``prec`` in the program's place where ``prec`` is not None."""
        pts = torch.from_numpy(self.model.grid()).to(self.device)
        steps = self.sugg["lloyd_steps"]
        worst = [-math.inf, -math.inf]
        for centers, conf, pdf, u_bins, u_seeds in samples:
            args = (pdf.to(self.device), pts, u_bins.to(self.device),
                    u_seeds.to(self.device), steps)
            if prec is not None:
                centers, conf, _mass = self.model.palettes(*args, prec)[0]
            errs = palette_errors(centers, conf, self.model.palettes(*args))
            worst = [max(a, b) for a, b in zip(worst, errs)]
        return tuple(v if math.isfinite(v) else None for v in worst)

    def _result(self, map_err, chain, limits) -> tuple[bool, dict]:
        nums = {"map_err_max": map_err}
        nums.update(zip(CHAIN_NUMBERS, chain))
        out = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
        ok = all(v is not None and v <= limits[k] for k, v in nums.items())
        return ok, out

    def check(self, limits: dict) -> tuple[bool, dict]:
        kept, n = self.kept, len(self.kept)
        if not n:
            return self._result(None, (None, None), limits)
        w = self.model.load_weights(self.cfg, self.seed, self.device)
        ref = self.ref_pdfs(kept.meta, "float32", w, len(self.maps))
        port_pdf = [kept.get("pdf", j) for j in range(n)]
        ref_pdf = [r[0] for r in ref]
        for m, j in enumerate(self.maps.meta):
            port_pdf.append(self.maps.get("map", m))
            ref_pdf.append(ref[j][1])
        map_err = check.map_err_max(port_pdf, ref_pdf)
        del ref, w
        samples = [(kept.get("centers", j), kept.get("conf", j),
                    torch.from_numpy(kept.get("pdf", j)),
                    torch.from_numpy(kept.get("u_bins", j)),
                    torch.from_numpy(kept.get("u_seeds", j)))
                   for j in range(n)]
        return self._result(map_err, self._palette_numbers(samples, None),
                            limits)

    def control(self, n_actions: int, prec: str, limits: dict) -> dict:
        """The check with the reference at ``prec`` put in the program's
        place: the same image, tables, pixels and sample as a run of
        ``n_actions`` actions, draws from a generator seeded from the seed;
        maps and palettes at ``prec`` compared with the float32 reference's
        as the program's are. No program runs."""
        H, W = self.mix["image_hw"]
        self.image = inputs.image(inputs.rng(self.seed, "image"), H, W)
        w = self.model.load_weights(self.cfg, self.seed, self.device)
        actions = Actions(inputs.rng(self.seed, "script"), self.S, self.mix)
        sample = inputs.rng(self.seed, "sample")
        metas = []
        for i in range(n_actions):
            _new, table, pixel = actions.next(i)
            if (sample.random() < 1.0 / self.mix["sample_every"]
                    and i >= self.mix["trace_actions"]):
                metas.append((table, pixel))
        if not metas:
            return self._result(None, (None, None), limits)[1]
        whole = self.mix["map_samples"]
        low = self.ref_pdfs(metas, prec, w, whole)
        ref = self.ref_pdfs(metas, "float32", w, whole)
        port_pdf = [x for r in low for x in r]
        ref_pdf = [x for r in ref for x in r]
        gen = torch.Generator(device=self.device).manual_seed(
            int(inputs.rng(self.seed, "pool").integers(0, 1 << 62)))
        K, N = self.sugg["K"], self.sugg["N"]
        samples = []
        for r in low:
            u_bins = torch.rand(N, generator=gen, device=self.device)
            u_seeds = torch.rand((self.sugg["restarts"], K), generator=gen,
                                 device=self.device)
            samples.append((None, None, torch.from_numpy(r[0]), u_bins,
                            u_seeds))
        return self._result(check.map_err_max(port_pdf, ref_pdf),
                            self._palette_numbers(samples, prec), limits)[1]
