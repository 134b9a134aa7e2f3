"""Histogram transfer: one image recolored under reference after reference,
closed loop, one client.

One seeded target image is loaded in set-up, and a pool of ``refs`` seeded
uint8 RGB references is made in host memory. Action ``i`` hands the entry
reference ``i mod refs``, so the histogram changes at every action; the
entry passes no local hints. Actions follow each other with no think time,
as a user stepping through candidate references does.

The check compares, once the window has closed, every action that the
seeded sample picked (one in ``sample_every``, past the first
``trace_actions``, at most ``samples_per_s_max`` a second of the window)
with the plain references, computed from the same target, reference and
weights:

- ``hist_err_max``: the largest absolute difference of a bin between the
  histogram the program read back and ``reference.glob_stats``'s;
- ``frame_diff_share`` and ``ab_err_mean``: the frame against the float32
  reference net given the histogram the program read back. Under seeded
  weights one pooled pixel moved to a neighbouring bin (1/4096 of the
  mass) moves about a fifth of the frame's values, so the net is held to
  the frame given the program's own histogram, and the histogram is held
  to its reference on its own."""

from __future__ import annotations

import math

import numpy as np
import torch

from harness import check, inputs
from harness.store import Store
from reference import color, glob_stats, resize

FRAME_NUMBERS = ("frame_diff_share", "ab_err_mean")


class Driver:
    def __init__(self, cell, model, entry, seed: int, device, fault=None):
        self.cfg, self.mix = cell.config, cell.mix
        self.model, self.entry = model, entry
        self.seed, self.device, self.fault = seed, device, fault
        self.S = self.cfg["Xd"]
        self.flops = model.flops(self.cfg, self.S)
        self._prev = None
        self.mark = lambda what: None

    def _pool(self) -> list:
        r = inputs.rng(self.seed, "pool")
        H, W = self.mix["ref_hw"]
        return [inputs.image(r, H, W) for _ in range(self.mix["refs"])]

    def prepare(self, seconds: float, warm_profiler: bool = False) -> None:
        H, W = self.mix["image_hw"]
        self.image = inputs.image(inputs.rng(self.seed, "image"), H, W)
        self.refs = self._pool()
        w = self.model.load_weights(self.cfg, self.seed, self.device)
        self.mark("images and weights")
        self.sess = self.entry.Session(self.cfg, self.image, w, self.device)
        if self.fault == "no_hist":          # the histogram never reaches
            fwd = self.sess.m.net_forward    # the net: -1 in its place
            self.sess.m.net_forward = lambda ab, mask, _glob: fwd(ab, mask,
                                                                  -1)
        self.mark("session open")
        # the weights the reference will take: the bytes the program got
        self.w_host = {k: v.cpu() for k, v in w.items()}
        del w
        for i in range(self.mix["warmup_actions"]):
            frame = self.call(self.inputs(i))
        self.mark("warm-up")
        ans = self.sess.answer()
        self.kept = Store(math.ceil(seconds * self.mix["samples_per_s_max"]),
                          {"frame": frame, "ab": ans["ab"],
                           "hist": ans["hist"]})
        del ans
        self.mark("sample store")
        if warm_profiler:                    # the profiler's own start-up
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                self.call(self.inputs(0))
        self.sample = inputs.rng(self.seed, "sample")
        self._prev = None

    def inputs(self, i) -> dict:
        return {"ref": i % len(self.refs)}

    def call(self, inp):
        out = self.sess.call(self.refs[inp["ref"]])
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
        ans = self.sess.answer()
        self.kept.put(inp["ref"], frame=out, ab=ans["ab"], hist=ans["hist"])

    def work(self, inp) -> dict:
        return {"size": self.S, "k2_fused_frames": self.entry.K2_FUSED_FRAMES,
                "flops": self.flops}

    def close(self) -> None:
        self.sess.close()
        del self.sess

    # ----- the check -----
    def l_plane(self) -> torch.Tensor:
        """(1, 1, S, S) L of the net-size target, worked out again."""
        small = resize.resize_u8(torch.from_numpy(self.image), self.S, self.S)
        lab = color.rgb_to_lab(small.to(self.device).to(torch.float32)
                               / 255.0)
        return lab[None, None, ..., 0]

    def ref_hists(self, prec: str) -> torch.Tensor:
        """(refs, 313) histograms of the pool's references at ``prec``."""
        small = torch.stack([resize.resize_u8(torch.from_numpy(r), self.S,
                                              self.S) for r in self.refs])
        return glob_stats.histogram(small.to(self.device).to(torch.float32)
                                    / 255.0, prec)

    def frames(self, hists: torch.Tensor, prec: str, w: dict) -> dict:
        """The reference net's frames and their ab for (n, 313) ``hists``,
        at ``prec``, in blocks."""
        l = self.l_plane()
        out = {"frame": [], "ab": []}
        block = self.mix["check_block"]
        for s in range(0, len(hists), block):
            h = hists[s:s + block].to(self.device)
            with torch.no_grad():
                r = self.model.reference(w, self.cfg,
                                         l.expand(len(h), -1, -1, -1), h,
                                         prec)
                frames = color.lab_to_rgb_u8(l[:, 0], r["pred"][:, 0],
                                             r["pred"][:, 1])
                fab = color.frame_ab(frames)
            out["frame"] += list(frames.cpu().numpy())
            out["ab"] += list(fab.cpu().numpy())
        return out

    def _result(self, tally, hist_err, limits) -> tuple[bool, dict]:
        ok, nums = tally.result({k: limits[k] for k in FRAME_NUMBERS})
        nums["hist_err_max"] = {"value": hist_err,
                                "limit": limits["hist_err_max"]}
        return (ok and hist_err is not None
                and hist_err <= limits["hist_err_max"]), nums

    def check(self, limits: dict) -> tuple[bool, dict]:
        tally = check.Tally(FRAME_NUMBERS)
        if not len(self.kept):
            return self._result(tally, None, limits)
        kept, n = self.kept, len(self.kept)
        port_h = torch.from_numpy(np.stack([kept.get("hist", j)
                                            for j in range(n)]))
        want = self.ref_hists("float32").cpu()[list(kept.meta)]
        hist_err = float((port_h - want).abs().max())
        w = {k: v.to(self.device) for k, v in self.w_host.items()}
        ref = self.frames(port_h, "float32", w)
        tally.add({"frame": [kept.get("frame", j) for j in range(n)],
                   "ab": [kept.get("ab", j) for j in range(n)]}, ref, n)
        return self._result(tally, hist_err, limits)

    def control(self, n_actions: int, prec: str, limits: dict) -> dict:
        """The check with the reference at ``prec`` put in the program's
        place: the same target, references and weights as a run of
        ``n_actions`` actions, its histograms and frames compared as the
        program's are. No program runs."""
        H, W = self.mix["image_hw"]
        self.image = inputs.image(inputs.rng(self.seed, "image"), H, W)
        self.refs = self._pool()
        w = self.model.load_weights(self.cfg, self.seed, self.device)
        sample = inputs.rng(self.seed, "sample")
        picked = [i % len(self.refs) for i in range(n_actions)
                  if sample.random() < 1.0 / self.mix["sample_every"]
                  and i >= self.mix["trace_actions"]]
        tally = check.Tally(FRAME_NUMBERS)
        if not picked:
            return self._result(tally, None, limits)[1]
        low_h = self.ref_hists(prec)[picked]
        want = self.ref_hists("float32")[picked]
        hist_err = float((low_h - want).abs().max())
        tally.add(self.frames(low_h, prec, w),
                  self.frames(low_h, "float32", w), len(picked))
        return self._result(tally, hist_err, limits)[1]
