"""Tracing and profiling instrumentation.

Counterpart of ``ideepcolor_tpu/utils/profiling.py``: a per-stage latency
recorder with p50/p95 summaries (the server's ``/stats`` and ``/metrics``
read it), and a thin layer over ``torch.profiler`` for device traces: a
trace context that writes a Chrome trace (viewable in Perfetto), named spans
inside it, and a summary of where the device time went.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from collections import defaultdict

import numpy as np

TRACE_FILE = "trace.json"


class StageTimer:
    """Accumulates per-stage wall-clock samples; reports percentiles.

    ``maxlen`` bounds the per-stage window (long-running servers keep the
    most recent samples instead of growing without bound)."""

    def __init__(self, maxlen: int | None = None):
        if maxlen is None:
            self.samples: dict[str, list] = defaultdict(list)
        else:
            from functools import partial
            self.samples = defaultdict(
                partial(collections.deque, maxlen=maxlen))

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self.samples[name].append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            a = np.sort(np.asarray(list(xs))) * 1000.0
            out[name] = {
                "n": len(a),
                "p50_ms": float(a[len(a) // 2]),
                "p95_ms": float(a[min(len(a) - 1, int(len(a) * 0.95))]),
                "mean_ms": float(a.mean()),
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<28}{'n':>6}{'p50 ms':>10}{'p95 ms':>10}"
                 f"{'mean ms':>10}"]
        for name, s in sorted(self.summary().items()):
            lines.append(f"{name:<28}{s['n']:>6}{s['p50_ms']:>10.2f}"
                         f"{s['p95_ms']:>10.2f}{s['mean_ms']:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the block: the host's ops always, the
    card's kernels and copies when CUDA is available. On exit the trace is
    written to ``log_dir/trace.json`` (Chrome trace format; Perfetto reads
    it), the file :func:`device_op_summary` parses."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named trace span for host-side stages inside a device_trace."""
    from torch.profiler import record_function
    return record_function(name)


# the device lane of a trace: what ran on the card
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _group(name: str) -> str:
    """conv / copy / elementwise / other, from a CUDA kernel's name (cuDNN's
    convolution kernels are implicit GEMMs named fprop, dgrad, wgrad or
    xmma; PyTorch's pointwise ops are its elementwise kernels)."""
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


def _outermost(events: list) -> list:
    """Of host ops nested on one thread, the outermost (an op's children
    would count its time twice)."""
    out, ends = [], {}
    for e in sorted(events, key=lambda e: (e.get("pid"), e.get("tid"),
                                           e["ts"], -e.get("dur", 0.0))):
        key = (e.get("pid"), e.get("tid"))
        if e["ts"] >= ends.get(key, float("-inf")):
            out.append(e)
            ends[key] = e["ts"] + e.get("dur", 0.0)
    return out


def device_op_summary(log_dir: str, reps: int = 1) -> dict:
    """Parse a :func:`device_trace` capture into a per-op time summary.

    The card's kernels, copies and memsets when the trace has them; for a
    trace taken on the CPU, where the CPU is the device, its outermost
    ``aten`` ops. Returns {"total_ms_per_rep", "groups": {group:
    ms_per_rep}, "top_ops": [(name, ms_per_rep), ...]}, the JAX function's
    shape; ``reps`` divides the summed durations by the number of identical
    steps captured."""
    path = os.path.join(log_dir, TRACE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {TRACE_FILE} under {log_dir}")
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if not device:
        device = _outermost([e for e in events if e.get("cat") == "cpu_op"])
    agg: collections.Counter = collections.Counter()
    for e in device:
        agg[e["name"]] += e.get("dur", 0.0)
    groups: collections.Counter = collections.Counter()
    for n, d in agg.items():
        groups[_group(n)] += d
    to_ms = 1.0 / (1000.0 * max(reps, 1))
    return {
        "total_ms_per_rep": sum(agg.values()) * to_ms,
        "groups": {g: d * to_ms for g, d in groups.most_common()},
        "top_ops": [(n, d * to_ms) for n, d in agg.most_common(20)],
    }
