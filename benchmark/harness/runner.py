"""One run of one cell: set-up, the measured window, the check, the
result line. The driver of the cell's traffic makes the inputs and calls
the program; everything timed or counted here is the harness's own."""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np

from . import device as devrec
from . import program
from .spec import Cell
from .trace import WINDOW_SPAN, Trace


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _window(drv, seconds: float, trace_n: int, torch):
    """Closed loop for ``seconds``: each action's inputs are made, its
    call into the program is timed to the result in host memory, and its
    outputs are kept where the check samples them. With ``trace_n`` the
    first ``trace_n`` actions run under the profiler, inside the
    ``bench.window`` span. Returns (latencies s, units done, attempted,
    failed, window s, trace dir or None, work of the traced actions)."""
    lat, units, attempted, failed, work = [], 0, 0, 0, []
    prof = span = tdir = None
    if trace_n:
        from torch.profiler import ProfilerActivity, profile, record_function
        tdir = tempfile.mkdtemp(prefix="bench_trace_")
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
        span = record_function(WINDOW_SPAN)
        span.__enter__()

    def stop_trace():
        _sync(torch)
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(tdir, "trace.json"))

    start = time.perf_counter()
    end = start
    i = 0
    while time.perf_counter() - start < seconds:
        inp = drv.inputs(i)
        attempted += 1
        t0 = time.perf_counter()
        out = drv.call(inp)
        t1 = time.perf_counter()
        end = t1
        if out is None:
            failed += 1
        else:
            lat.append(t1 - t0)
            units += drv.units(inp)
        drv.after(i, inp, out)
        if prof is not None:
            work.append(drv.work(inp))
        i += 1
        if prof is not None and i == trace_n:
            stop_trace()
            prof = None
    if prof is not None:
        stop_trace()
    return lat, units, attempted, failed, end - start, tdir, work


def _end_to_end(cell, lat, units, window_s, setup_s) -> dict:
    ms = np.asarray(lat) * 1e3
    values = {"setup_s": setup_s, "images_per_s": units / window_s}
    if len(ms):
        values["latency_ms_p50"] = float(statistics.median(ms))
        values["latency_ms_p95"] = float(np.percentile(ms, 95))
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def _per_layer(cell, tr: Trace, work, model) -> dict:
    ctx = {"trace": tr, "work": work, "config": cell.config,
           "mix": cell.mix, "model": model}
    out = {}
    for m in cell.per_layer:
        v = cell.metric(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", clock=None, fault=None,
        overrides: dict | None = None, marks: list | None = None) -> dict:
    """The result of one run, the contract's last line as a dict. For the
    harness's own tests on the CPU: ``fault`` breaks the program's outputs
    underneath the driver, and ``overrides`` ({"config": {...}, "mix":
    {...}}) shrinks the sizes. ``marks``: the set-up's marks so far, (what,
    seconds from the process start)."""
    import torch
    clock = clock or devrec.Clock()
    marks = list(marks or [])
    cell = Cell(name)
    for part, values in (overrides or {}).items():
        getattr(cell, part).update(values)
    model, entry = cell.model(), cell.entry()
    marks.append(("the cell's files", clock.since_start()))
    if device == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)           # the context, made here
        torch.cuda.synchronize()
        marks.append(("CUDA context", clock.since_start()))
        compiled = program.build()
        marks.append(("program builds" + (" (compiled)" if compiled else
                                          " (loaded)"), clock.since_start()))
    drv = cell.driver().Driver(cell, model, entry, seed, device, fault=fault)
    drv.mark = lambda what: marks.append((what, clock.since_start()))
    trace_n = int(cell.mix["trace_actions"]) if trace else 0
    drv.prepare(seconds, warm_profiler=bool(trace_n))
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = clock.since_start()
    marks.append(("set-up", setup_s))
    print("set-up, seconds from the process start: " + ", ".join(
        f"{w} {t:.3f}" for w, t in marks), file=sys.stderr)
    lat, units, attempted, failed, window_s, tdir, work = _window(
        drv, seconds, trace_n, torch)
    if device == "cuda":
        torch.cuda.synchronize()
        dev = devrec.record(torch, cell.chips)
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
    if len(lat) >= 8:
        ms = np.asarray(lat) * 1e3
        q = np.array_split(ms, 4)
        print("window quarters p50/p95 ms: " + "; ".join(
            f"{np.median(x):.3f}/{np.percentile(x, 95):.3f}" for x in q)
            + "; p90/p99 " + "/".join(f"{np.percentile(ms, p):.3f}"
                                      for p in (90, 99)), file=sys.stderr)
    drv.close()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    result = {"correct": False, "attempted": attempted, "failed": failed}
    if trace_n:
        try:
            tr = Trace.from_file(os.path.join(tdir, "trace.json"))
        finally:
            shutil.rmtree(tdir, ignore_errors=True)
        result["metrics"] = _per_layer(cell, tr, work, model)
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    else:
        result["metrics"] = _end_to_end(cell, lat, units, window_s, setup_s)
    result["device"] = dev
    ok, numbers = drv.check(cell.limits)
    result["correct"] = bool(ok and failed == 0 and len(lat) > 0
                             and all(math.isfinite(m["value"])
                                     for m in result["metrics"].values()))
    result["check"] = numbers
    return result


def main(argv=None) -> int:
    import argparse
    clock = devrec.Clock()
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    marks = [("python and torch imported", clock.since_start())]
    need = Cell(args.workload).chips
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    marks.append(("CUDA driver started", clock.since_start()))
    if have < need:
        print(f"this cell needs {need} CUDA device(s); {have} available",
              file=sys.stderr)
        return 2
    res = run(args.workload, args.seed, args.seconds, bool(args.trace),
              clock=clock, marks=marks)
    # read after the window: nvidia-smi's start is no part of set-up
    print(f"device: {devrec.power_limit()}", file=sys.stderr)
    bad = devrec.forbidden_modules()
    if bad:
        print(f"modules of the JAX package or JAX were loaded: {bad[:10]}",
              file=sys.stderr)
        return 3
    for k, v in res["check"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(res))
    return 0
