"""Reduction of a ``torch.profiler`` Chrome trace of the measured window.

The device's time is the union of its intervals (kernels, copies, sets),
so work that overlaps on two streams counts once; a trace with no device
interval in the window is an error, never a reading of the host. The
window is the ``bench.window`` span the harness opens around the traced
actions. Kernel names are grouped as the program's own trace summary
groups them (cuDNN's implicit GEMMs are ``conv``, PyTorch's pointwise ops
``elementwise``)."""

from __future__ import annotations

import bisect
import collections
import json

WINDOW_SPAN = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync")


def group(name: str) -> str:
    """conv / copy / elementwise / other, from a device operation's name."""
    n = name.lower()
    if any(k in n for k in ("conv", "fprop", "dgrad", "wgrad", "xmma",
                            "cudnn", "implicit_gemm")):
        return "conv"
    if any(k in n for k in ("memcpy", "memset", "copy", "cat_", "catarray",
                            "transpose", "permute")):
        return "copy"
    if "elementwise" in n or "pointwise" in n:
        return "elementwise"
    return "other"


def union(intervals) -> list[tuple[float, float]]:
    """Merged, sorted (start, end) intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """The events of one trace inside its window; times in microseconds
    as the trace gives them, results in seconds."""

    def __init__(self, events: list[dict]):
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and e.get("name") == WINDOW_SPAN]
        if not spans:
            raise ValueError(f"the trace has no {WINDOW_SPAN!r} span")
        self.t0 = spans[0]["ts"]
        self.t1 = self.t0 + spans[0]["dur"]
        clip = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            s, t = max(e["ts"], self.t0), min(e["ts"] + e.get("dur", 0.0),
                                              self.t1)
            if t > s:
                clip.append((e["name"], s, t))
        if not clip:
            raise ValueError("no device operation ran in the traced window: "
                             "the profiler saw no card")
        self.device = clip
        self.busy = union((s, t) for _n, s, t in clip)
        self.host = [e for e in events if e.get("ph") == "X"
                     and e.get("cat") in HOST_CATS
                     and e.get("name") != WINDOW_SPAN
                     and self.t0 <= e["ts"] <= self.t1]

    @classmethod
    def from_file(cls, path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel_s(self, *substrings: str) -> float:
        """Device seconds of the operations whose names hold any of
        ``substrings`` (their own union)."""
        return sum(e - s for s, e in union(
            (s, t) for n, s, t in self.device
            if any(k in n for k in substrings))) * 1e-6

    def launches(self) -> int:
        """Host calls that put work on a stream: kernel and graph
        launches and asynchronous copies, by the CUDA runtime's names."""
        return sum(1 for e in self.host if e["name"] in LAUNCH_CALLS)

    def device_ops(self, n: int = 10) -> list:
        agg: collections.Counter = collections.Counter()
        for name, s, t in self.device:
            agg[f"{group(name)}: {name[:120]}"] += (t - s) * 1e-6
        return [[k, v] for k, v in agg.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest idle gaps of the window, each named by the
        host operation that covered most of it (the innermost of those
        that cover at least half of it)."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        host = sorted(self.host, key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        out = []
        for d, g0, g1 in gaps:
            best, best_key = "no host operation", None
            for e in host[:bisect.bisect_right(starts, g1)]:
                ov = min(e["ts"] + e.get("dur", 0.0), g1) - max(e["ts"], g0)
                if ov <= 0:
                    continue
                key = (ov >= 0.5 * d, -e.get("dur", 0.0) if ov >= 0.5 * d
                       else ov)
                if best_key is None or key > best_key:
                    best, best_key = e["name"][:120], key
            out.append([best, d * 1e-6])
        return out
