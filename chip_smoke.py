#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ideepcolor_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
(the kernels are built for sm_90a) and the CUDA toolkit. Phases, one line
or more each; any failure exits non-zero:

1. environment: Python, torch and CUDA versions, and the card's name and
   power limit as nvidia-smi reports them;
2. build: both kernel sources of ideepcolor_tpu_torch/csrc (K1's library
   exports the by-value entry and the batched, device-count entry; K2's
   the compose, the fused click entry and the batched compose), one nvcc
   each, in parallel, timed;
3. K1 (hint rasterizer) against its plain version on the card, bit-exact,
   at 0, 10, 200 and 256 live hints (overlapping, across the edges) at
   S=256 and at S=250 (not a multiple of 4); timed at the main path's
   table (10 hints) and at 200 hints, with the box tests its tile culling
   leaves beside those of a full scan per pixel. Its batched entry (counts
   read on the device) at N=1 and N=8 against the plain loop, bit-exact,
   and inside ONE captured CUDA graph replayed with the count changed in
   place between replays (0, 10, 200, 256, and counts past both ends);
4. K2 against its plain version on the card, <= 1 LSB on < 1e-3 of the
   values, at the click frame, the main path's full-res frame (750 wide,
   not a multiple of 4) and 1536x2048, in five plane layouts: contiguous
   planes, stride-3 L with planar ab (L as a channel of a Lab image),
   stride-2 ab views (the full-res getter), stride-0 zero ab (the
   mask and gray getters) and a plane 4 bytes off 16-byte alignment; each
   timed, with the bytes the layout really moves beside the 15 B/px bound.
   Then the dist session's two compose shapes in its own layouts, under
   the same bar: the 512x512 window frame (contiguous L, the two channels
   of a zoom_with_matrices output; timed) and the 1 x K palette (three
   stride-3 planes of a (K,3) Lab tensor) at K = 1, 9 and 25.
   The fused entry: its frame byte-identical to the compose's, its ab
   within 1e-3 of requantized_ab of that frame, timed. The batched entry
   at N=8 and N=1 at 256x256 and N=3 at 33x17, in the batch engine's planar
   layout and with channel-last ab: the same bar, and each frame equal to
   the single-frame entry's;
5. the main path: ColorizeImageTorch(Xd=256) with the bundled full-width
   teacher weights -- load a seeded 1000x750 image, a table click with no
   hint, ten clicks that add hints, a dense click, the full-res, mask and
   sup full-res getters -- with every kernel entry's launch count read
   around it; the same session on the CPU (plain kernel versions, CPU
   convs) must give the same frames within the bound below (1 LSB on <
   1e-3 of the pixels of each frame, output_ab within 1e-3 where the
   frames agree); click latency, and a profile of five clicks that says
   where the device time goes, how many device kernels a click runs and
   how many launches the host makes for it. On the card the API's clicks
   are captured CUDA graphs, so the rasterizer on this path is K1's
   device-count entry and a kernel's count adds its graph nodes at every
   replay;
6. the dist session, the GUI's second path: ColorizeImageTorch and
   ColorizeImageTorchDist with the teacher at Xd=256 on the same image --
   predict_dist_table, a table click, ten click+suggest clicks
   (net_forward_table_win_suggest) with a 512-px window and cubic matrices,
   get_ab_reccs, suggest_table (K=9), compute_entropy and snap_ab -- with
   the launch counts read around it apart from phase 5's (K1 and both K2
   entries must launch here too). Checked: the map's shape, finiteness and
   row sums; each click's net frame byte-identical to net_forward_table's
   for the same table when cuDNN's deterministic kernels are chosen (its
   default transposed convs accumulate with atomics, so two forwards of
   one input differ in the last bits: the session's own frames are held
   to the frame bound below); the last window frame against K2's plain
   version on the session's own tensors; palette row 0 the previous
   frame's pixel;
   confidences sorted and summing to 1; centers inside [-110, 110]. Against
   a CPU twin of the session (fewer clicks): the distribution map, the
   window frames, the entropy, snap_ab, and the k-means chain's
   deterministic cores on shared random numbers (bins_from_uniform,
   _lloyd). Timed: the click+suggest click, predict_dist_table and
   suggest_table on the host clock, the device kernels per click+suggest
   click and the k-means chain alone from the profiler, and how far 20
   forwards of one table lie apart with cuDNN's default kernels;
7. captured against eager. A second session whose graphs are captured
   with cuDNN's deterministic kernels chosen: the table, window and
   click+suggest clicks, predict_dist_table and suggest_table through the
   API (graph replays) against the plain functions they were captured from
   (``program.fn``), at tables of 0, 4 and 10 hints: frames, output_ab and
   hint planes byte-equal, map within 1e-5; the suggest chain's
   deterministic cores, captured, equal to the eager ones on shared random
   numbers; two replays draw different samples and a re-seeded generator
   the same ones. Then each click timed captured and eager in turns within
   this one run (p50/p95 on the host clock), with the device kernels, the
   host's launches, device busy time and idle share of each;
8. the serving precisions: a bf16 session (prep_net(dtype="bfloat16")) and
   a precision_name="default" (TF32) session against the f32 session on
   the same tables: frame_delta_stats, PSNR, max |d output_ab| and the
   distribution map's max |dp|, each held to BF16_BOUND / TF32_BOUND below;
   the captured table click's p50/p95 and device time in the three modes;
9. the async getters (byte-equal to the synchronous ones, also after the
   model's state has moved on), then the engines with launch counts of
   their own: InteractiveSession (40 submits, one latest per 4: counters,
   submit never waits for the device, last frame, window frame and hint
   mirrors equal the synchronous clicks'), StreamingSession (120 uint8
   frames at depth 4, table and dense hints, with and without the
   distribution map, against the direct step; frames/s);
10. the batch engine: colorize_batch_table at N=8 against the per-image f32
   table clicks and stream_window_u8 at T=8 against the per-frame step, by
   frame_delta_stats within TF32_BOUND; every K1 and K2 entry, the two
   batched ones included, must have launched on the engines' path;
11. one JSON line listing each kernel entry with its launches on the three
   paths, its error against the plain version, its time, the plain
   version's, its bound and what sets it, and the shape and plane layout
   those numbers were measured at;
12. last line: {"ok": true, "device": {...}}.

Times are device times from CUDA events: a kernel's ``ms`` and the plain
version's ``plain_ms`` are the median over 50 replays of a CUDA graph of 20
calls, divided by 20. ``bound_ms`` is the larger of the bytes the function
must move over 3.35 TB/s and its f32 operations over 67 TFLOP/s (the H100
SXM data sheet's HBM rate and f32 rate outside the tensor cores). No single
PyTorch call computes either function, so ``library_ms`` is null.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K2_OPS_PER_PIXEL = 60        # f32 operations of the chain, pow counted once
K2_AB_OPS_PER_PIXEL = 100    # the fused entry: the chain, then RGB -> Lab ab
K2_BAR = (1, 1e-3)           # K2 vs plain: max LSB, share of values
AB_BAR = 1e-3                # fused ab vs requantized_ab of the same frame
S = 256
FULLRES_HW = (1000, 750)
K2_SIZES = ((S, S), FULLRES_HW, (1536, 2048))
FRAME_BOUND_LSB = 1          # card vs CPU session, per channel
FRAME_BOUND_SHARE = 1e-3     # of the pixels of any one frame
WEIGHTS = "weights/teacher.npz"
WIN = 512                    # the GUI's window size
SUGGEST_K = 9                # the GUI's palette
DIST_CPU_CLICKS = 2          # of the ten click+suggest clicks, on the CPU
MAP_BOUND = 1e-5             # distribution map, card vs CPU, max |d p|
BINS_MOVED_BOUND = 5         # of 25000 samples: f32 cumsum order differs
# a serving-precision session against the f32 session, over table clicks of
# 0, 4 and 10 hints: frames (frame_delta_stats: max LSB, share of equal
# pixels; PSNR in dB), output_ab and the distribution map
# (measured on an H100: bf16 22 LSB, 0.689, 53.06 dB, 3.52, 1.09e-3; TF32
# 1 LSB, 0.975, 68.81 dB, 1.03, 9.9e-5). TF32's frame bounds also hold two
# TF32 runs of other batch sizes, whose convs take other kernels
BF16_BOUND = dict(max_lsb=40, equal=0.55, psnr=48.0, dab=8.0, map=5e-3)
TF32_BOUND = dict(max_lsb=3, equal=0.95, psnr=60.0, dab=2.5, map=5e-4)


def die(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def device_ms(fn, reps: int = 20, samples: int = 50) -> float:
    """Median device time of one call of ``fn``: ``reps`` calls captured in
    a CUDA graph, replayed ``samples`` times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def eager_ms(fn, reps: int = 20, samples: int = 50) -> float:
    """Median time of one eager call, host launch included: CUDA events
    around ``reps`` back-to-back calls."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def image(seed: int, H: int, W: int) -> np.ndarray:
    """A seeded smooth color field with noise, uint8 (H, W, 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * yy + c) * np.cos(5 * xx - 2 * c)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 12, (H, W, 3)),
                   0, 255).astype(np.uint8)


def session_hints(n: int, seed: int = 7) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"y": int(rng.integers(0, S)), "x": int(rng.integers(0, S)),
             "ab": rng.uniform(-80, 80, 2).tolist(),
             "radius": int(rng.integers(1, 5))} for _ in range(n)]


def k1_table(n_live: int, size: int = S, seed: int = 1):
    """A 256-slot table: n_live overlapping boxes, many across the edges."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((256, 4), np.int32)
    values = np.zeros((256, 2), np.float32)
    for i in range(256):
        y, x = rng.integers(-10, size + 10, 2)
        r = rng.integers(0, 13)
        boxes[i] = [y - r, x - r, y + r, x + r]
        values[i] = rng.uniform(-100, 100, 2)
    return boxes, values, n_live


def k1_box_tests(boxes, count: int, size: int = S) -> tuple[int, int, int]:
    """Box tests of this table: (K1's cull, K1's scan, a full scan per
    pixel). K1 tests every live slot against each 8x64 tile, then each
    thread scans its tile's list from the end until its four pixels are
    covered (all of it where one is not). A full scan per pixel goes from
    slot count-1 down to the first cover (all count slots without one)."""
    if count == 0:
        return 0, 0, 0
    b = boxes[:count]
    ys, xs = np.mgrid[0:size, 0:size]
    last = np.full((size, size), -1)
    for k in range(count):
        last[(ys >= b[k, 0]) & (ys <= b[k, 2]) & (xs >= b[k, 1])
             & (xs <= b[k, 3])] = k
    full = int(np.where(last >= 0, count - last, count).sum())
    cull = scan = 0
    for ty in range(0, size, 8):
        for tx in range(0, size, 64):
            y1, x1 = min(ty + 8, size) - 1, min(tx + 64, size) - 1
            cull += count
            hit = ((b[:, 0] <= y1) & (b[:, 2] >= ty) & (b[:, 1] <= x1)
                   & (b[:, 3] >= tx))
            rank = np.cumsum(hit) - 1         # place in the tile's list
            n = int(hit.sum())
            tile = last[ty:y1 + 1, tx:x1 + 1]
            j = np.where(tile >= 0, rank[np.maximum(tile, 0)], -1)
            pad = (-j.shape[1]) % 4
            j = np.pad(j, ((0, 0), (0, pad)), constant_values=n)
            groups = j.reshape(j.shape[0], -1, 4)
            first = np.where((groups < 0).any(-1), 0, groups.min(-1))
            scan += int((n - first).sum())
    return cull, scan, full


def needed(planes, out_bytes: int) -> int:
    """Bytes the function must move: each distinct input element once (a
    stride-0 plane is one element), plus the output."""
    seen = {(t.data_ptr(), t.stride()): 1 if t.stride() == (0, 0)
            else t.numel() for t in planes}
    return 4 * sum(seen.values()) + out_bytes


def traffic(planes, out_bytes: int) -> int:
    """Bytes a call really moves: each storage the planes read spans, once,
    plus the output."""
    spans = {}
    for t in planes:
        lo = t.data_ptr()
        hi = lo + 4 * (1 + sum((n - 1) * st for n, st in
                               zip(t.shape, t.stride())))
        key = t.untyped_storage().data_ptr()
        old = spans.get(key, (lo, hi))
        spans[key] = (min(lo, old[0]), max(hi, old[1]))
    return sum(hi - lo for lo, hi in spans.values()) + out_bytes


def lsb(got, want) -> tuple[int, float]:
    d = (got.int() - want.int()).abs()
    return int(d.max()), float((d != 0).float().mean())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the card",
              file=sys.stderr)
        return 1
    from ideepcolor_tpu_torch.api import (ColorizeImageTorch,
                                          ColorizeImageTorchDist)
    from ideepcolor_tpu_torch.data import lab_gamut
    from ideepcolor_tpu_torch.engine import batch as B
    from ideepcolor_tpu_torch.engine import graphs
    from ideepcolor_tpu_torch.engine import pipeline as P
    from ideepcolor_tpu_torch.engine import streaming as ST
    from ideepcolor_tpu_torch.engine.interactive import InteractiveSession
    from ideepcolor_tpu_torch.ops import colorspace as cs
    from ideepcolor_tpu_torch.ops import hints
    from ideepcolor_tpu_torch.ops import kmeans as km
    from ideepcolor_tpu_torch.ops import resize
    from ideepcolor_tpu_torch.ops.cuda import build
    from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as k2
    from ideepcolor_tpu_torch.ops.cuda import hints_kernel as k1
    dev = torch.device("cuda")
    entries = (k1.KERNEL, k1.KERNEL_BATCH, k2.KERNEL, k2.KERNEL_AB,
               k2.KERNEL_BATCH)
    # the entries each path must put on the card: the API's clicks are
    # captured graphs, whose rasterizer is K1's device-count entry
    click_entries = (k1.KERNEL_BATCH, k2.KERNEL, k2.KERNEL_AB)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()}")
    print(smi)

    # 2. build
    secs = build.build_all(entries)
    print(f"build: {secs:.1f} s for {k1.KERNEL.source} and "
          f"{k2.KERNEL.source}")
    for k in (k1.KERNEL, k2.KERNEL):
        for line in k.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {k.source}: {line.strip()}")

    report = {}

    # 3. K1: bit-exact at 0/10/200/256 live hints at S=256 and S=250, then
    # timed at the main path's table and at 200 hints
    def k1_pair(table, size=S):
        b = torch.from_numpy(table[0]).to(dev)
        v = torch.from_numpy(table[1]).to(dev)
        kern = lambda: k1.rasterize_hints_planar(b, v, table[2], size)  # noqa
        def plain():
            ab, mask = hints.rasterize_hints(b, v, table[2], size)
            return torch.cat([ab, mask], -1).permute(2, 0, 1)
        return kern, plain

    k1_err = 0.0
    for size in (S, 250):
        for n in (0, 10, 200, 256):
            kern, plain = k1_pair(k1_table(n, size), size)
            got, want = kern(), plain()
            err = float((got - want).abs().max())
            k1_err = max(k1_err, err)
            if not torch.equal(got, want):
                die(f"K1 differs from its plain version at S={size}, {n} "
                    f"live hints (max |d| {err})")
    print(f"K1 check: S={S} and S=250, 0, 10, 200 and 256 live hints: "
          f"bit-exact with the plain version")
    for label, table in (("200 hints", k1_table(200)),
                         ("main path, 10 hints",
                          hints.points_json_to_table(session_hints(10), S))):
        kern, plain = k1_pair(table)
        n = table[2]
        b_ms, b_by = bound(3 * S * S * 4 + 24 * n + 4)
        cull, scan, full = k1_box_tests(table[0], n)
        ms, p_ms, e_ms = device_ms(kern), device_ms(plain), eager_ms(kern)
        print(f"K1 time ({label}): kernel {ms:.5f} ms, plain {p_ms:.5f} ms,"
              f" eager call {e_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by}), "
              f"share of bound {b_ms / ms:.3f}; box tests: cull {cull} + "
              f"scan {scan} (a full scan per pixel: {full})")
    report[k1.KERNEL.name] = dict(
        max_abs_err=k1_err, ms=ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, shape=[S, S],
        layout=f"{n} live hints of 256 slots, planar (3,{S},{S}) f32 out")

    # the batched entry (counts read on the device): N = 1 and 8 tables
    # against the plain loop, then ONE captured graph replayed with the
    # count changed in place between replays
    live = (0, 10, 200, 256, 3, 77, 255, 1)

    def k1_batch_inputs(N, size=S):
        tabs = [k1_table(n, size, seed=20 + i) for i, n in
                enumerate(live[:N])]
        return (torch.from_numpy(np.stack([t[0] for t in tabs])).to(dev),
                torch.from_numpy(np.stack([t[1] for t in tabs])).to(dev),
                torch.tensor(live[:N], dtype=torch.int32, device=dev))

    kb_err = 0.0
    for size in (S, 250):
        for N in (1, 8):
            b, v, c = k1_batch_inputs(N, size)
            got = k1.rasterize_hints_batch(b, v, c, size)
            want = k1.rasterize_hints_batch_plain(b, v, c, size)
            kb_err = max(kb_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                die(f"K1 batched entry differs from its plain version at "
                    f"S={size}, N={N}")
    b, v, _ = k1_batch_inputs(1)
    b, v = b[0].contiguous(), v[0].contiguous()
    cnt = torch.zeros(1, dtype=torch.int32, device=dev)
    raster = graphs.GraphProgram(
        lambda b, v, c: k1.rasterize_hints_planar(b, v, c, S))
    for n in (0, 10, 200, 256, 10, 300, -3):
        cnt.fill_(n)
        got = raster(graphs.Fixed(b), graphs.Fixed(v), graphs.Fixed(cnt))
        if not torch.equal(got, k1._planar_plain(b, v, n, S)):
            die(f"K1 in a captured graph: count {n} set between replays "
                f"gives another raster than the plain version")
    if raster.captures != 1 or raster.replays != 7:
        die(f"K1 graph: {raster.captures} captures, {raster.replays} "
            f"replays")
    print(f"K1 batched entry: N=1 and N=8 at S={S} and S=250 bit-exact "
          f"with the plain loop; one captured graph replayed with counts 0, "
          f"10, 200, 256, 10, 300 (clamped) and -3 (clamped) set between "
          f"replays: bit-exact each time ({raster.captures} capture, "
          f"{raster.replays} replays)")
    for N in (1, 8):
        b, v, c = k1_batch_inputs(N)
        if N == 1:                  # the main path's table, as a click has it
            t = hints.points_json_to_table(session_hints(10), S)
            b = torch.from_numpy(t[0]).to(dev)[None]
            v = torch.from_numpy(t[1]).to(dev)[None]
            c = torch.tensor([t[2]], dtype=torch.int32, device=dev)
        n_live = int(c.clamp(0, 256).sum())
        b_ms, b_by = bound(N * (3 * S * S * 4 + 4) + 24 * n_live)
        ms = device_ms(lambda: k1.rasterize_hints_batch(b, v, c, S))
        p_ms = device_ms(
            lambda: k1.rasterize_hints_batch_plain(b, v, c, S), reps=4)
        print(f"K1 batched time (N={N}, {n_live} live hints in all): kernel "
              f"{ms:.5f} ms, plain loop {p_ms:.5f} ms, bound {b_ms:.6f} ms "
              f"({b_by}), share of bound {b_ms / ms:.3f}")
        if N == 1:
            report[k1.KERNEL_BATCH.name] = dict(
                max_abs_err=kb_err, ms=ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, shape=[1, S, S],
                layout=f"N=1, {n_live} live hints of 256 slots, count in "
                       f"device memory (the captured clicks'); N=8 on the "
                       f"line above")

    # 4. K2: <= 1 LSB on < 1e-3 of the values, three sizes, five layouts
    rng = np.random.default_rng(2)
    worst = (0, 0.0)
    for H, W in K2_SIZES:
        lab = torch.from_numpy(np.concatenate(
            [rng.uniform(0, 100, (H, W, 1)),
             rng.uniform(-110, 110, (H, W, 2))],
            -1).astype(np.float32)).to(dev)
        l = lab[..., 0].contiguous()
        ab = lab[..., 1:].permute(2, 0, 1).contiguous()   # planar: U-Net
        ab_hwc = lab[..., 1:].contiguous()                # as a zoom output
        zero = torch.zeros((), device=dev).expand(H, W)   # stride 0
        off = torch.empty(H * W + 4, device=dev)[1:H * W + 1].view(H, W)
        off.copy_(ab[0])                                  # 4 B off 16 B
        layouts = {
            "contiguous": (l, ab[0], ab[1]),
            "stride-3 L, planar ab": (lab[..., 0], ab[0], ab[1]),
            "stride-2 ab": (l, ab_hwc[..., 0], ab_hwc[..., 1]),
            "stride-0 ab": (l, zero, zero),
            "misaligned a": (l, off, ab[1]),
        }
        kernel_ms = {}
        for layout, planes in layouts.items():
            w, s = lsb(k2.lab_to_rgb_u8_hwc(*planes),
                       k2.lab_to_rgb_u8_plain(*planes))
            if w > K2_BAR[0] or s >= K2_BAR[1]:
                die(f"K2 at {H}x{W}, {layout}: {w} LSB on {s:.2e} of the "
                    f"values")
            worst = max(worst[0], w), max(worst[1], s)
            ms = kernel_ms[layout] = device_ms(
                lambda: k2.lab_to_rgb_u8_hwc(*planes))
            moved = traffic(planes, 3 * H * W)
            nbytes = needed(planes, 3 * H * W)
            b_ms, _ = bound(nbytes, K2_OPS_PER_PIXEL * H * W)
            print(f"K2 {H}x{W} {layout} ({k2.load_modes(*planes)}): {w} LSB "
                  f"on {s:.2e} of the values; kernel {ms:.5f} ms, moves "
                  f"{moved / (H * W):.2f} B/px ({moved / ms / 1e9:.3f} TB/s),"
                  f" bound {b_ms:.6f} ms at {nbytes / (H * W):.2f} B/px, "
                  f"share {b_ms / ms:.3f}")
        # the full-res getter's layout; contiguous planes elsewhere
        layout = "stride-2 ab" if (H, W) == FULLRES_HW else "contiguous"
        planes = layouts[layout]
        p_ms = device_ms(lambda: k2.lab_to_rgb_u8_plain(*planes))
        e_ms = eager_ms(lambda: k2.lab_to_rgb_u8_hwc(*planes))
        print(f"K2 {H}x{W} {layout}: plain {p_ms:.5f} ms, eager call "
              f"{e_ms:.5f} ms")
        if (H, W) == FULLRES_HW:
            b_ms, b_by = bound(15 * H * W, K2_OPS_PER_PIXEL * H * W)
            report[k2.KERNEL.name] = dict(
                ms=kernel_ms[layout], plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, shape=[H, W],
                layout="L contiguous, stride-2 ab (the full-res getter's)")

        # the fused entry, on the click's layout and one scalar-load layout
        ab_worst = 0.0
        for layout in ("contiguous", "stride-3 L, planar ab"):
            planes = layouts[layout]
            rgb, got_ab = k2.lab_to_rgb_u8_ab(*planes)
            if not torch.equal(rgb, k2.lab_to_rgb_u8_hwc(*planes)):
                die(f"K2 fused entry at {H}x{W}, {layout}: its frame is not "
                    f"the compose's")
            d = float((got_ab - cs.requantized_ab(rgb)).abs().max())
            if not d <= AB_BAR:
                die(f"K2 fused entry at {H}x{W}, {layout}: ab off "
                    f"requantized_ab by {d}")
            ab_worst = max(ab_worst, d)
        planes = layouts["contiguous"]
        ms = device_ms(lambda: k2.lab_to_rgb_u8_ab(*planes))
        def plain():
            rgb = k2.lab_to_rgb_u8_plain(*planes)
            return rgb, cs.requantized_ab(rgb)
        p_ms = device_ms(plain)
        e_ms = eager_ms(lambda: k2.lab_to_rgb_u8_ab(*planes))
        b_ms, b_by = bound(23 * H * W, K2_AB_OPS_PER_PIXEL * H * W)
        print(f"K2 fused {H}x{W}: frame byte-identical to the compose's, ab "
              f"within {ab_worst:.2e} of requantized_ab; kernel {ms:.5f} ms,"
              f" plain {p_ms:.5f} ms, eager call {e_ms:.5f} ms, bound "
              f"{b_ms:.6f} ms at 23 B/px ({b_by}), share {b_ms / ms:.3f}")
        if (H, W) == (S, S):                      # the click's frame
            report[k2.KERNEL_AB.name] = dict(
                ab_max_abs_err=ab_worst, ms=ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, shape=[H, W],
                layout="L and planar ab contiguous (the click's)")
    # the dist session's two compose shapes, in its own layouts
    cubic = torch.from_numpy(resize.cubic_resize_matrix_np(S, WIN)).to(dev)
    win_ab = resize.zoom_with_matrices(
        torch.from_numpy(rng.uniform(-110, 110, (S, S, 2)).astype(
            np.float32)).to(dev), cubic, cubic)
    win_l = torch.from_numpy(rng.uniform(0, 100, (WIN, WIN, 1)).astype(
        np.float32)).to(dev)
    planes = (win_l[..., 0], win_ab[..., 0], win_ab[..., 1])
    w, s = lsb(k2.lab_to_rgb_u8_hwc(*planes), k2.lab_to_rgb_u8_plain(*planes))
    if w > K2_BAR[0] or s >= K2_BAR[1]:
        die(f"K2 at the {WIN}x{WIN} window frame: {w} LSB on {s:.2e} of the "
            f"values")
    worst = max(worst[0], w), max(worst[1], s)
    ms = device_ms(lambda: k2.lab_to_rgb_u8_hwc(*planes))
    p_ms = device_ms(lambda: k2.lab_to_rgb_u8_plain(*planes))
    b_ms, _ = bound(15 * WIN * WIN, K2_OPS_PER_PIXEL * WIN * WIN)
    print(f"K2 {WIN}x{WIN} window frame, contiguous L and a zoom output's ab "
          f"({k2.load_modes(*planes)}): {w} LSB on {s:.2e} of the values; "
          f"kernel {ms:.5f} ms, plain {p_ms:.5f} ms, bound {b_ms:.6f} ms, "
          f"share {b_ms / ms:.3f}")
    pal_modes, pal_off, pal_values, pal_worst = set(), 0, 0, 0
    for K in (1, SUGGEST_K, 25):
        for _ in range(64):
            l_net = torch.from_numpy(rng.uniform(0, 100, (S, S, 1)).astype(
                np.float32)).to(dev)
            centers = torch.from_numpy(rng.uniform(-110, 110, (K, 2)).astype(
                np.float32)).to(dev)
            lab = P._palette_lab(l_net, int(rng.integers(S)),
                                 int(rng.integers(S)), centers)
            planes = tuple(lab[None, :, c] for c in range(3))
            d = (k2.lab_to_rgb_u8_hwc(*planes).int()
                 - k2.lab_to_rgb_u8_plain(*planes).int()).abs()
            pal_modes.add(k2.load_modes(*planes))
            pal_worst = max(pal_worst, int(d.max()))
            pal_off += int((d != 0).sum())
            pal_values += d.numel()
    if pal_worst > K2_BAR[0] or pal_off / pal_values >= K2_BAR[1]:
        die(f"K2 at the 1 x K palette: {pal_worst} LSB on {pal_off} of "
            f"{pal_values} values")
    worst = max(worst[0], pal_worst), max(worst[1], pal_off / pal_values)
    print(f"K2 1 x K palette, K = 1, {SUGGEST_K} and 25, 64 random palettes "
          f"each, stride-3 planes of a (K,3) Lab tensor ({sorted(pal_modes)}):"
          f" {pal_off} of {pal_values} values off the plain version, max "
          f"{pal_worst} LSB")
    # the batched entry: the batch engine's (N,1,S,S) L and (N,2,S,S)
    # prediction, channel-last ab, and an odd size whose frames do not start
    # on 4 pixels
    for N, H, W in ((8, S, S), (1, S, S), (3, 33, 17)):
        l = torch.from_numpy(rng.uniform(0, 100, (N, 1, H, W)).astype(
            np.float32)).to(dev)
        ab = torch.from_numpy(rng.uniform(-110, 110, (N, 2, H, W)).astype(
            np.float32)).to(dev)
        hwc = ab.permute(0, 2, 3, 1).contiguous()
        for layout, planes in (
                ("planar prediction", (l[:, 0], ab[:, 0], ab[:, 1])),
                ("channel-last ab", (l[:, 0], hwc[..., 0], hwc[..., 1]))):
            got = k2.lab_to_rgb_u8_batch(*planes)
            w, sh = lsb(got, k2.lab_to_rgb_u8_plain(*planes))
            if w > K2_BAR[0] or sh >= K2_BAR[1]:
                die(f"K2 batched entry at {N}x{H}x{W}, {layout}: {w} LSB on "
                    f"{sh:.2e} of the values")
            for i in range(N):
                if not torch.equal(got[i], k2.lab_to_rgb_u8_hwc(
                        *(t[i] for t in planes))):
                    die(f"K2 batched entry at {N}x{H}x{W}, {layout}: frame "
                        f"{i} is not the single-frame entry's")
            worst = max(worst[0], w), max(worst[1], sh)
            if (N, H) == (8, S) and layout == "planar prediction":
                ms = device_ms(lambda: k2.lab_to_rgb_u8_batch(*planes))
                p_ms = device_ms(lambda: k2.lab_to_rgb_u8_plain(*planes))
                b_ms, b_by = bound(15 * N * H * W,
                                   K2_OPS_PER_PIXEL * N * H * W)
                print(f"K2 batched {N}x{H}x{W} {layout} "
                      f"({k2.load_modes(*planes)}): {w} LSB on {sh:.2e} of "
                      f"the values, each frame the single-frame entry's; "
                      f"kernel {ms:.5f} ms, plain {p_ms:.5f} ms, bound "
                      f"{b_ms:.6f} ms ({b_by}), share {b_ms / ms:.3f}")
                report[k2.KERNEL_BATCH.name] = dict(
                    ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                    shape=[N, H, W],
                    layout="(N,1,S,S) L and (N,2,S,S) prediction planes, "
                           "batch strides S*S and 2*S*S (the batch "
                           "engine's)")
    for k in (k2.KERNEL, k2.KERNEL_AB, k2.KERNEL_BATCH):
        report[k.name]["max_abs_err"] = worst[0]
    print(f"K2 compose: max {worst[0]} LSB on {worst[1]:.2e} of the values "
          f"over {len(K2_SIZES)} sizes and {len(layouts)} layouts, the "
          f"{WIN}x{WIN} window frame and the 1 x K palettes (bar "
          f"{K2_BAR[0]} LSB on < {K2_BAR[1]})")
    print("library_ms: null for every K1 and K2 entry: no single PyTorch "
          "call computes either function")

    # 5. the main path on the card, launches counted; then the CPU session
    def session(device):
        m = ColorizeImageTorch(Xd=S, device=device)
        m.prep_net(path=WEIGHTS)
        frames, click_s = {}, []
        m.load_image_array(image(5, *FULLRES_HW))
        frames["click0"] = m.net_forward_table(
            *hints.points_json_to_table([], S))
        frames["ab0"] = m.output_ab
        clicks = session_hints(10)
        for i in range(1, len(clicks) + 1):
            t0 = time.perf_counter()
            frames[f"click{i}"] = m.net_forward_table(
                *hints.points_json_to_table(clicks[:i], S))
            click_s.append(time.perf_counter() - t0)
            frames[f"ab{i}"] = m.output_ab
        ab = np.zeros((2, S, S), np.float32)
        mask = np.zeros((1, S, S), np.float32)
        for h in session_hints(6, seed=8):
            hints.put_point(ab, mask, [min(max(h["y"], 4), S - 5),
                                       min(max(h["x"], 4), S - 5)], 4,
                            h["ab"])
        frames["dense"] = m.net_forward(ab, mask)
        frames["ab_dense"] = m.output_ab
        frames["fullres"] = m.get_img_fullres()
        frames["mask_fullres"] = m.get_img_mask_fullres()
        frames["sup_fullres"] = m.get_sup_fullres()
        return m, frames, click_s

    for k in entries:
        k.launches = 0
    t0 = time.perf_counter()
    m, gpu, click_s = session(None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in entries}
    print(f"main path on the card: {wall:.2f} s, launches {launches}")
    for k in click_entries:
        if launches[k.name] == 0:
            die(f"kernel {k.name} was not launched on the main path")
    for key, f in gpu.items():
        if not np.isfinite(f).all():
            die(f"main path: {key} is not finite")
    for key in ("click0", "click10", "dense"):
        if gpu[key].shape != (S, S, 3) or gpu[key].dtype != np.uint8:
            die(f"main path: {key} is {gpu[key].shape} {gpu[key].dtype}")
    for key in ("fullres", "mask_fullres", "sup_fullres"):
        if gpu[key].shape != FULLRES_HW + (3,):
            die(f"main path: {key} is {gpu[key].shape}")
    if not m.input_mask.any():
        die("main path: the dense click saw no hint")

    # click latency, for information: more clicks with the last table
    table = hints.points_json_to_table(session_hints(10), S)
    for _ in range(40):
        t0 = time.perf_counter()
        m.net_forward_table(*table)
        click_s.append(time.perf_counter() - t0)
    ms = np.array(click_s[1:]) * 1e3
    print(f"table click on the card (host clock, frame read back): p50 "
          f"{np.percentile(ms, 50):.3f} ms, p95 {np.percentile(ms, 95):.3f}"
          f" ms over {len(ms)} clicks")

    # where a click's device time goes, for information
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_profile(fn, n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        averages = prof.key_averages()
        events = sorted((e for e in averages
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
        kernels = sum(e.count for e in events
                      if not e.key.startswith(("Memcpy", "Memset")))
        # what the host put on the stream: kernel launches, graph launches
        # and copies, by the runtime's own names
        host = {}
        for e in averages:
            if e.device_type == DeviceType.CPU and e.key.startswith(
                    ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                     "cudaMemcpy", "cudaMemset")):
                host[e.key] = host.get(e.key, 0) + e.count / n
        profile_host.clear()
        profile_host.update(host)
        return events, kernels / n, wall_ms

    profile_host = {}

    def host_launches() -> str:
        """The last profile's host-side launches per call, by kind."""
        total = sum(profile_host.values())
        kinds = ", ".join(f"{v:.0f} {k}" for k, v in
                          sorted(profile_host.items()))
        return f"{total:.0f} host launches per click ({kinds})"

    events, per_click, wall_ms = device_profile(
        lambda: m.net_forward_table(*table), 5)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    copies = sum(e.count for e in events) / 5 - per_click
    table_launches = host_launches()
    rgb = torch.from_numpy(gpu["click10"]).to(dev)
    _, chain, _ = device_profile(lambda: cs.requantized_ab(rgb), 1)
    print(f"profile of 5 table clicks (captured): wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms (share {busy_ms / wall_ms:.3f}), "
          f"{len(events)} distinct device activities; {per_click:.0f} device"
          f" kernels and {copies:.0f} copies per click, "
          f"{table_launches} (the plain "
          f"requantized_ab chain that K2's fused entry replaces is "
          f"{chain:.0f} kernels)")
    for e in events[:12]:
        print(f"  {e.self_device_time_total / 5:10.1f} us/click "
              f"{e.count // 5:4d}x  {e.key[:100]}")

    t0 = time.perf_counter()
    _, cpu, _ = session("cpu")
    print(f"the same session on the CPU: {time.perf_counter() - t0:.1f} s")
    worst_frame, worst_share, worst_ab = 0, 0.0, 0.0
    for key, want in cpu.items():
        got = gpu[key]
        if got.dtype == np.uint8:
            d = np.abs(got.astype(int) - want.astype(int)).max(-1)
            worst_frame = max(worst_frame, int(d.max()))
            worst_share = max(worst_share, float(np.mean(d != 0)))
            if d.max() > FRAME_BOUND_LSB or np.mean(d != 0) >= \
                    FRAME_BOUND_SHARE:
                die(f"{key}: card vs CPU {d.max()} LSB on "
                    f"{np.mean(d != 0):.2e} of the pixels")
        else:
            frame = gpu["dense" if key == "ab_dense" else "click" + key[2:]]
            same = (frame == cpu["dense" if key == "ab_dense"
                                 else "click" + key[2:]]).all(-1)
            if same.any():
                worst_ab = max(worst_ab, float(
                    np.abs(got - want).max(0)[same].max()))
    if worst_ab > 1e-3:
        die(f"output_ab: card vs CPU {worst_ab} where the frames agree")
    print(f"card vs CPU session: frames within {worst_frame} LSB on at most "
          f"{worst_share:.2e} of a frame's pixels (bound {FRAME_BOUND_LSB} "
          f"LSB on < {FRAME_BOUND_SHARE}); output_ab within {worst_ab:.2e} "
          f"where the frames agree (bound 1e-3)")

    # 6. the dist session on the card, launches counted apart from phase
    # 5's; then its CPU twin on fewer clicks
    clicks = session_hints(10)
    tables = [hints.points_json_to_table(clicks[:i], S)
              for i in range(len(clicks) + 1)]
    snap_colors = np.random.default_rng(9).integers(
        0, 256, (8, 3)).astype(np.float32)

    def dist_session(device, n_clicks):
        m = ColorizeImageTorch(Xd=S, device=device)
        m.prep_net(path=WEIGHTS)
        d = ColorizeImageTorchDist(Xd=S, device=device)
        d.prep_net(path=WEIGHTS)
        im = image(5, *FULLRES_HW)
        m.load_image_array(im)
        d.set_image(m.img_rgb)             # the GUI hands it the net size
        win_rgb = resize.resize_u8_half_pixel(m._to_dev(im), (WIN, WIN))
        window = (P.rgb_to_lab_dev_u8(win_rgb)[..., :1].contiguous(),
                  m._to_dev(resize.cubic_resize_matrix_np(S, WIN)),
                  m._to_dev(resize.cubic_resize_matrix_np(S, WIN)))
        out, click_s = {}, []
        if d.predict_dist_table(*tables[0]) != 0:
            die("dist session: predict_dist_table failed")
        out["map"] = d._dev_dist.cpu().numpy()
        out["net0"] = m.net_forward_table(*tables[0])
        for i in range(1, n_clicks + 1):
            h, w = clicks[i - 1]["y"], clicks[i - 1]["x"]
            prev = m.output_rgb[h, w].copy()
            t0 = time.perf_counter()
            res = m.net_forward_table_win_suggest(
                *tables[i], *window, d, h, w, K=SUGGEST_K)
            click_s.append(time.perf_counter() - t0)
            if isinstance(res, int):
                die(f"dist session: click+suggest click {i} returned {res}")
            out[f"win{i}"], out[f"colors{i}"] = res
            out[f"net{i}"] = m.output_rgb
            # CUDA's division by a host scalar multiplies by its
            # reciprocal, so row 0 is the pixel / 255 to 1 ulp, not bitwise
            if (np.abs(res[1][0] - prev.astype(np.float32) / 255).max()
                    > 1e-6 or not np.array_equal(np.rint(res[1][0] * 255),
                                                 prev)):
                die(f"dist session: click {i}: palette row 0 {res[1][0]} is "
                    f"not the previous frame's pixel {prev}")
        # the last window frame again, by K2's plain version on the
        # session's own tensors (no launch)
        z = resize.zoom_with_matrices(m._dev_output_ab, window[1], window[2])
        out["win_plain"] = k2.lab_to_rgb_u8_plain(
            window[0][..., 0], z[..., 0], z[..., 1]).cpu().numpy()
        h, w = clicks[n_clicks - 1]["y"], clicks[n_clicks - 1]["x"]
        out["reccs"] = d.get_ab_reccs(h, w, K=SUGGEST_K, return_conf=True)
        out["palette"] = d.suggest_table(*tables[n_clicks], h, w,
                                         K=SUGGEST_K)
        out["map_suggest"] = d._dev_dist.cpu().numpy()
        d.compute_entropy()
        out["entropy"] = d.dist_entropy
        out["snap"] = np.stack([
            lab_gamut.snap_ab(l_in, c, device=device)
            for l_in in (20.0, 50.0, 80.0) for c in snap_colors])
        return m, d, window, out, click_s

    for k in entries:
        k.launches = 0
    t0 = time.perf_counter()
    dm, dd, window, dgpu, dclick_s = dist_session(None, len(clicks))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dist_launches = {k.name: k.launches for k in entries}
    print(f"dist session on the card: {wall:.2f} s, launches {dist_launches}")
    for k in click_entries:
        if dist_launches[k.name] == 0:
            die(f"kernel {k.name} was not launched on the dist session")

    for key in ("map", "map_suggest"):
        dmap = dgpu[key]
        if dmap.shape != (S // 4, S // 4, 529) or not np.isfinite(dmap).all():
            die(f"dist session: {key} is {dmap.shape}, or not finite")
        if np.abs(dmap.sum(-1) - 1).max() > 1e-4:
            die(f"dist session: {key}'s rows sum to 1 within "
                f"{np.abs(dmap.sum(-1) - 1).max():.2e} only")
    win_lsb, win_share = lsb(torch.from_numpy(dgpu[f"win{len(clicks)}"]),
                             torch.from_numpy(dgpu["win_plain"]))
    if win_lsb > K2_BAR[0] or win_share >= K2_BAR[1]:
        die(f"dist session: the last window frame is {win_lsb} LSB on "
            f"{win_share:.2e} of the values from K2's plain version on the "
            f"same tensors")
    rerun_share = 0.0
    for i in range(1, len(clicks) + 1):
        win, colors = dgpu[f"win{i}"], dgpu[f"colors{i}"]
        if win.shape != (WIN, WIN, 3) or win.dtype != np.uint8:
            die(f"dist session: window frame {i} is {win.shape} {win.dtype}")
        if (colors.shape != (SUGGEST_K + 1, 3) or colors.min() < 0
                or colors.max() > 1 or not np.isfinite(colors).all()):
            die(f"dist session: colors {i} are {colors.shape}, outside "
                f"[0,1] or not finite")
        # launched after the counts were read: comparisons, not the path.
        # cuDNN's default transposed-conv kernels accumulate with atomics,
        # so two forwards of one input differ in the last bits of ab and a
        # few bytes of the frame; the session's frame is held to the frame
        # bound here, and byte for byte in phase 7, whose session is
        # captured with the deterministic kernels chosen
        want = dm.net_forward_table(*tables[i])
        d = np.abs(want.astype(int) - dgpu[f"net{i}"].astype(int)).max(-1)
        rerun_share = max(rerun_share, float(np.mean(d != 0)))
        if d.max() > FRAME_BOUND_LSB or np.mean(d != 0) >= FRAME_BOUND_SHARE:
            die(f"dist session: click {i}'s net frame is {d.max()} LSB on "
                f"{np.mean(d != 0):.2e} of the pixels from "
                f"net_forward_table's for the same table")
    centers, conf = dgpu["reccs"]
    colors_u8, pal_conf = dgpu["palette"]
    if colors_u8.shape != (SUGGEST_K, 3) or colors_u8.dtype != np.uint8:
        die(f"suggest_table: colors are {colors_u8.shape} {colors_u8.dtype}")
    for name, c in (("get_ab_reccs", conf), ("suggest_table", pal_conf)):
        if (c.shape != (SUGGEST_K,) or abs(float(c.sum()) - 1) > 1e-5
                or (np.diff(c) > 0).any()):
            die(f"{name}: confidences {c} do not sum to 1 within 1e-5, or "
                f"are not sorted")
    if centers.shape != (SUGGEST_K, 2) or np.abs(centers).max() > 110:
        die(f"get_ab_reccs: centers {centers.shape} leave [-110, 110]")
    if not np.isfinite(dgpu["entropy"]).all() or \
            dgpu["entropy"].shape != (S, S) or (dgpu["entropy"] > 0).any():
        die("compute_entropy: not finite, not (Xd, Xd) or positive")
    print(f"dist session checks: map ({S // 4},{S // 4},529) finite, rows "
          f"sum to 1 within {np.abs(dgpu['map'].sum(-1) - 1).max():.2e}; "
          f"{len(clicks)} net frames within 1 LSB on at most "
          f"{rerun_share:.2e} of the pixels of net_forward_table's (cuDNN's "
          f"default kernels; byte for byte in phase 7); "
          f"the last window frame {win_lsb} LSB on {win_share:.2e} of the "
          f"values from K2's plain version on the same tensors; "
          f"palette row 0 the previous pixel; confidences sorted, sum "
          f"{float(conf.sum()):.7f}; centers within "
          f"{np.abs(centers).max():.1f}; top confidence {conf[0]:.3f}")

    # timings, for information: the click+suggest click with the last table
    h, w = clicks[-1]["y"], clicks[-1]["x"]
    sug_click = lambda: dm.net_forward_table_win_suggest(  # noqa: E731
        *tables[-1], *window, dd, h, w, K=SUGGEST_K)

    def host_ms(fn, n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return np.array(out)

    # how far two forwards of one table lie apart with cuDNN's default
    # kernels (the deterministic ones must not differ at all)
    dm.net_forward_table(*tables[-1])
    net_in = (dm._dev_l_mc.permute(2, 0, 1)[None],
              dm._to_dev(dm.input_ab)[None], dm._to_dev(dm.input_mask)[None])
    spread = {}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        try:
            with torch.no_grad():
                outs = [dm._fwd_tbl(*net_in) for _ in range(20)]
            spread[det] = max(float((o - outs[0]).abs().max())
                              for o in outs[1:])
        finally:
            torch.backends.cudnn.deterministic = False
    if spread[True] != 0:
        die(f"the deterministic forward differs run to run: {spread[True]}")
    print(f"20 forwards of one table: max |d ab| {spread[False]:.3e} with "
          f"cuDNN's default kernels, {spread[True]:.1e} with the "
          f"deterministic ones")
    ms = np.concatenate([np.array(dclick_s[1:]) * 1e3, host_ms(sug_click, 40)])
    print(f"click+suggest click on the card (host clock, window frame and "
          f"palette read back): p50 {np.percentile(ms, 50):.3f} ms, p95 "
          f"{np.percentile(ms, 95):.3f} ms over {len(ms)} clicks")
    for name, fn in (
            ("predict_dist_table",
             lambda: dd.predict_dist_table(*tables[-1])),
            ("suggest_table (K=9)",
             lambda: dd.suggest_table(*tables[-1], h, w, K=SUGGEST_K))):
        fn()
        ms = host_ms(fn, 20)
        print(f"{name} on the card (host clock): p50 "
              f"{np.percentile(ms, 50):.3f} ms, p95 "
              f"{np.percentile(ms, 95):.3f} ms over {len(ms)} calls")
    events, per_click, wall_ms = device_profile(sug_click, 5)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    copies = sum(e.count for e in events) / 5 - per_click
    print(f"profile of 5 click+suggest clicks (captured): wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (share "
          f"{busy_ms / wall_ms:.3f}); {per_click:.0f} device kernels and "
          f"{copies:.0f} copies per click, {host_launches()}")
    for e in events[:8]:
        print(f"  {e.self_device_time_total / 5:10.1f} us/click "
              f"{e.count // 5:4d}x  {e.key[:100]}")
    chain = lambda: P.suggest_at(  # noqa: E731
        dd._dev_dist, h // 4, w // 4, dd._dev_pts(), dd._generator,
        K=SUGGEST_K)
    events, chain_kernels, wall_ms = device_profile(chain, 5)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3

    def chain_synced():
        chain()
        torch.cuda.synchronize()

    ms = host_ms(chain_synced, 20)
    print(f"the k-means chain alone (suggest_at, K={SUGGEST_K}, N=25000, 4 "
          f"restarts x 30 Lloyd steps): {chain_kernels:.0f} device kernels, "
          f"device busy {busy_ms / 5:.3f} ms per call (wall "
          f"{wall_ms / 5:.3f} ms under the profiler); host clock without "
          f"it, synchronized: p50 {np.percentile(ms, 50):.3f} ms, p95 "
          f"{np.percentile(ms, 95):.3f} ms over {len(ms)} calls")

    # card against the CPU twin
    t0 = time.perf_counter()
    _, cd, _, dcpu, _ = dist_session("cpu", DIST_CPU_CLICKS)
    print(f"the dist session's CPU twin ({DIST_CPU_CLICKS} click+suggest "
          f"clicks): {time.perf_counter() - t0:.1f} s")
    map_err = float(np.abs(dgpu["map"] - dcpu["map"]).max())
    if not map_err <= MAP_BOUND:
        die(f"distribution map: card vs CPU {map_err} (bound {MAP_BOUND})")
    worst_frame, worst_share = 0, 0.0
    for i in range(DIST_CPU_CLICKS + 1):
        for key in (f"win{i}", f"net{i}"):
            if key not in dcpu:
                continue
            d = np.abs(dgpu[key].astype(int) - dcpu[key].astype(int)).max(-1)
            worst_frame = max(worst_frame, int(d.max()))
            worst_share = max(worst_share, float(np.mean(d != 0)))
            if d.max() > FRAME_BOUND_LSB or \
                    np.mean(d != 0) >= FRAME_BOUND_SHARE:
                die(f"dist session {key}: card vs CPU {d.max()} LSB on "
                    f"{np.mean(d != 0):.2e} of the pixels")
    # the CPU twin's last map saw fewer hints: compare entropy of the first
    ent_gpu = P.dist_entropy(torch.from_numpy(dgpu["map"]).to(dev)).cpu()
    ent_err = float((ent_gpu - P.dist_entropy(
        torch.from_numpy(dcpu["map"]))).abs().max())
    if not ent_err <= 1e-3:
        die(f"dist_entropy: card vs CPU {ent_err}")
    snap_d = np.abs(dgpu["snap"].astype(int) - dcpu["snap"].astype(int))
    if snap_d.max() > 1:
        die(f"snap_ab: card vs CPU {snap_d.max()} LSB")
    # the chain's deterministic cores on shared random numbers
    pdf = torch.from_numpy(dcpu["map"][h // 4, w // 4])
    pts = cd._dev_pts()
    gen = torch.Generator().manual_seed(3)
    u = torch.rand(25000, generator=gen)
    counts = km.bins_from_uniform(pdf, u)
    counts_gpu = km.bins_from_uniform(pdf.to(dev), u.to(dev)).cpu()
    moved = int((counts - counts_gpu).abs().sum()) // 2
    if counts_gpu.sum() != 25000 or moved > BINS_MOVED_BOUND:
        die(f"bins_from_uniform: card vs CPU {moved} samples in another bin")
    c0 = km.seeds_from_uniform(pts, counts.float(),
                               torch.rand((4, SUGGEST_K), generator=gen))
    want = km._lloyd(pts, counts.float(), c0, SUGGEST_K, 30)
    got = km._lloyd(pts.to(dev), counts.float().to(dev), c0.to(dev),
                    SUGGEST_K, 30)
    lloyd_err = float((got[0].cpu() - want[0]).abs().max())
    if not lloyd_err <= 1e-3 or not torch.allclose(
            got[2].cpu(), want[2], rtol=1e-4):
        die(f"_lloyd: card vs CPU centers {lloyd_err}, inertia "
            f"{got[2].cpu().tolist()} vs {want[2].tolist()}")
    print(f"card vs CPU dist session: map within {map_err:.2e} (bound "
          f"{MAP_BOUND}); frames within {worst_frame} LSB on at most "
          f"{worst_share:.2e} of a frame's pixels; entropy within "
          f"{ent_err:.2e}; snap_ab: {int((snap_d != 0).sum())} of "
          f"{snap_d.size} values 1 LSB off; bins_from_uniform: {moved} of "
          f"25000 samples in another bin (bound {BINS_MOVED_BOUND}); _lloyd "
          f"centers within {lloyd_err:.2e}")

    # 7. captured against eager. The API's programs are captured graphs
    # (.fn is the plain function each was captured from). First one session
    # whose graphs are captured with cuDNN's deterministic kernels chosen,
    # so that captured and eager must agree byte for byte
    im = image(5, *FULLRES_HW)

    def up(table):
        return (torch.from_numpy(table[0]).to(dev),
                torch.from_numpy(table[1]).to(dev), int(table[2]))

    def seeded(gen, seed, fn):
        gen.manual_seed(seed)
        return fn()

    torch.backends.cudnn.deterministic = True
    try:
        cm = ColorizeImageTorch(Xd=S)
        cm.prep_net(path=WEIGHTS)
        cm.load_image_array(im)
        cd = ColorizeImageTorchDist(Xd=S)
        cd.prep_net(path=WEIGHTS)
        cd.set_image(cm.img_rgb)
        gen = cd._generator
        cap_map_err = 0.0
        for i in (0, 4, 10):
            b, v, c = up(tables[i])
            hy, wx = clicks[max(i, 1) - 1]["y"], clicks[max(i, 1) - 1]["x"]
            frame = cm.net_forward_table(*tables[i]).copy()
            out_ab = cm._dev_output_ab
            rgb, ab, planes = cm._click_tbl.fn(cm._dev_l_net, cm._dev_l_mc,
                                               b, v, c)
            if not (np.array_equal(frame, rgb.cpu().numpy())
                    and torch.equal(out_ab, ab)
                    and np.array_equal(cm.input_mask,
                                       planes[2:].cpu().numpy())):
                die(f"captured table click {i} differs from the eager one")
            win = cm.net_forward_table_win(*tables[i], *window)
            ewin = cm._click_tbl_win.fn(cm._dev_l_net, cm._dev_l_mc, *window,
                                        b, v, c)[2]
            if not (np.array_equal(win, ewin.cpu().numpy())
                    and np.array_equal(cm.output_rgb, frame)):
                die(f"captured window click {i} differs from the eager one")
            if cd.predict_dist_table(*tables[i]) != 0:
                die("captured predict_dist_table failed")
            emap = cd._predict_tbl.fn(cd._dev_l_mc, b, v, c)[0]
            cap_map_err = max(cap_map_err,
                              float((cd._dev_dist - emap).abs().max()))
            sug = lambda: cm.net_forward_table_win_suggest(  # noqa: E731
                *tables[i], *window, cd, hy, wx, K=SUGGEST_K)
            win2, colors = seeded(gen, 11, sug)
            if not (np.array_equal(win2, win)
                    and np.array_equal(cm.output_rgb, frame)):
                die(f"captured click+suggest click {i}: its frames are not "
                    f"the table click's and the window click's")
            # a graph and an eager call draw other numbers from one seed
            # (a captured generator takes its offset another way), so the
            # palettes are held by their contract here and the chain's
            # deterministic cores on shared numbers below
            pal, conf = cd.suggest_table(*tables[i], hy, wx, K=SUGGEST_K)
            cap_map_err = max(cap_map_err,
                              float((cd._dev_dist - emap).abs().max()))
            if (colors.shape != (SUGGEST_K + 1, 3) or colors.min() < 0
                    or colors.max() > 1 or pal.shape != (SUGGEST_K, 3)
                    or pal.dtype != np.uint8 or (np.diff(conf) > 0).any()
                    or abs(float(conf.sum()) - 1) > 1e-5
                    or not np.array_equal(
                        np.rint(colors[0] * 255), frame[hy, wx])):
                die(f"captured suggestions at table {i} break their "
                    f"contract: colors {colors}, palette {pal}, conf {conf}")
        # the generator is registered with the graphs: replays draw fresh
        # numbers, a re-seeded generator the same ones again
        first = seeded(gen, 5, lambda: sug()[1])
        second = sug()[1]
        again = seeded(gen, 5, lambda: sug()[1])
        if np.array_equal(first[1:], second[1:]) or \
                not np.array_equal(first, again):
            die("captured suggest chain: two replays drew the same samples, "
                "or a re-seeded generator did not reproduce them")
        if cap_map_err > MAP_BOUND:
            die(f"captured vs eager: map {cap_map_err}")
        # the chain's deterministic cores, captured, on shared numbers
        ugen = torch.Generator(device=dev).manual_seed(3)
        u_bins = torch.rand(25000, generator=ugen, device=dev)
        u_seed = torch.rand((4, SUGGEST_K), generator=ugen, device=dev)
        pdf = cd._dev_dist[hy // 4, wx // 4].clone()

        def cores(pdf, u_bins, u_seed, pts):
            counts = km.bins_from_uniform(pdf, u_bins).float()
            c0 = km.seeds_from_uniform(pts, counts, u_seed)
            return (counts, c0) + km._lloyd(pts, counts, c0, SUGGEST_K, 30)

        core_args = (pdf, u_bins, u_seed, cd._dev_pts())
        for got, want in zip(graphs.GraphProgram(cores)(*core_args),
                             cores(*core_args)):
            if not torch.equal(got, want):
                die("the suggest chain's cores, captured, differ from the "
                    "eager ones on the same random numbers")
    finally:
        torch.backends.cudnn.deterministic = False
    graphs_made = sum(p.captures for p in (
        cm._click_tbl, cm._click_tbl_win, cm._click_tbl_win_suggest,
        cd._predict_tbl, cd.ensure_suggest_program(SUGGEST_K, 25000)))
    print(f"captured vs eager, deterministic convolutions, tables of 0, 4 "
          f"and 10 hints: table, window and click+suggest frames byte-equal, "
          f"output_ab and hint planes equal; map within {cap_map_err:.2e} "
          f"(bound {MAP_BOUND}); the suggest chain's cores (sampler, "
          f"seeding, 30 Lloyd steps), captured, equal the eager ones on "
          f"shared random numbers; captured palettes keep their contract; "
          f"two replays draw different samples, a re-seed reproduces them; "
          f"{graphs_made} graphs captured for 5 programs")

    # the same clicks timed captured and eager in turns, default kernels,
    # on phase 6's session; the eager click is what the API did before
    # capture: upload the table, run the plain function, read back
    b, v, c = up(tables[-1])
    prev = torch.from_numpy(dm.output_rgb).to(dev)

    def eager_table():
        b, v, c = up(tables[-1])
        rgb, _, planes = dm._click_tbl.fn(dm._dev_l_net, dm._dev_l_mc, b, v, c)
        return planes.cpu(), rgb.cpu()

    def eager_win():
        b, v, c = up(tables[-1])
        out = dm._click_tbl_win.fn(dm._dev_l_net, dm._dev_l_mc, *window, b,
                                   v, c)
        return out[3].cpu(), out[2].cpu()

    def eager_sug():
        b, v, c = up(tables[-1])
        out = dm._click_tbl_win_suggest.fn(
            dm._dev_l_net, dm._dev_l_mc, *window, b, v, c, dd._dev_dist, h,
            w, dd._dev_pts(), prev, dd._generator, K=SUGGEST_K, N=25000,
            map_div=dd.dist_map_div)
        return out[4].cpu(), out[2].cpu(), out[3].cpu()

    def eager_predict():
        b, v, c = up(tables[-1])
        return dd._predict_tbl.fn(dd._dev_l_mc, b, v, c)[1].cpu()

    def eager_suggest_table():
        b, v, c = up(tables[-1])
        out = dd.ensure_suggest_program(SUGGEST_K, 25000).fn(
            dm._dev_l_net, dd._dev_l_mc, b, v, c, h, w, dd._dev_pts(),
            dd._generator)
        return out[3].cpu(), out[1].cpu(), out[2].cpu()

    click_times = {}
    for name, captured, eager in (
            ("table click", lambda: dm.net_forward_table(*tables[-1]),
             eager_table),
            ("window click",
             lambda: dm.net_forward_table_win(*tables[-1], *window),
             eager_win),
            ("click+suggest click", sug_click, eager_sug),
            ("predict_dist_table",
             lambda: dd.predict_dist_table(*tables[-1]), eager_predict),
            ("suggest_table",
             lambda: dd.suggest_table(*tables[-1], h, w, K=SUGGEST_K),
             eager_suggest_table)):
        captured()
        eager()
        t_cap = host_ms(captured, 20)
        t_eag = host_ms(eager, 20)
        t_cap = np.concatenate([t_cap, host_ms(captured, 20)])
        t_eag = np.concatenate([t_eag, host_ms(eager, 20)])
        line = [f"{name} (host clock, results read back, 40 calls each in "
                f"turns of 20)"]
        for label, fn, t in (("captured", captured, t_cap),
                             ("eager", eager, t_eag)):
            events, per_click, wall_ms = device_profile(fn, 5)
            busy_ms = sum(e.self_device_time_total for e in events) / 1e3
            line.append(
                f"{label}: p50 {np.percentile(t, 50):.3f} ms, p95 "
                f"{np.percentile(t, 95):.3f} ms; {per_click:.0f} device "
                f"kernels, {host_launches()}; device busy "
                f"{busy_ms / 5:.3f} ms per call, idle share "
                f"{1 - busy_ms / wall_ms:.3f} under the profiler")
            click_times[name, label] = (float(np.percentile(t, 50)),
                                        float(np.percentile(t, 95)))
        print("; ".join(line))
    if click_times["click+suggest click", "captured"][1] >= 16.7:
        print("note: the captured click+suggest click's p95 is over the "
              "16.7 ms limit in this run")

    # 8. the serving precisions against the f32 session: bf16 weights
    # (prep_net(dtype="bfloat16")) and precision_name="default" (TF32),
    # each captured, on the same image and tables
    def psnr(a, b):
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))

    def precision_models(dtype, precision_name):
        pm = ColorizeImageTorch(Xd=S)
        pm.prep_net(path=WEIGHTS, dtype=dtype)
        pd = ColorizeImageTorchDist(Xd=S)
        pd.prep_net(path=WEIGHTS, dtype=dtype)
        if precision_name != "highest":
            # the API serves at "highest"; the engines' mode through the
            # same factories
            mc = pm.mask_cent
            pm._click_tbl = P.make_table_click_program(
                lambda A, B_, M: pm.net(A, B_, M, mc,
                                        precision_name=precision_name),
                S, pm.device)

            def dist_fwd(l_mc, ab, mask):
                with torch.no_grad():
                    return pd.net(
                        l_mc.permute(2, 0, 1)[None], ab[None], mask[None],
                        mc, dist=True, dist_lowres=True,
                        precision_name=precision_name
                    )[1][0].permute(1, 2, 0).contiguous()

            pd._predict_tbl = P.make_table_dist_program(dist_fwd, S,
                                                        pd.device)
        pm.load_image_array(im)
        pd.set_image(pm.img_rgb)
        return pm, pd

    modes = {"f32": (m, dd)}
    modes["bf16"] = precision_models("bfloat16", "highest")
    modes["default"] = precision_models(None, "default")
    outs = {}
    for mode, (pm, pd) in modes.items():
        for i in (0, 4, 10):
            outs[mode, i] = (pm.net_forward_table(*tables[i]).copy(),
                             pm.output_ab.copy())
        pd.predict_dist_table(*tables[10])
        outs[mode, "map"] = pd._dev_dist.cpu().numpy()
    precision_stats = {}
    for mode, bar in (("bf16", BF16_BOUND), ("default", TF32_BOUND)):
        st = dict(max_lsb=0, equal=1.0, psnr=1e9, dab=0.0)
        for i in (0, 4, 10):
            got, want = outs[mode, i], outs["f32", i]
            max_lsb, equal = B.frame_delta_stats(got[0], want[0])
            st["max_lsb"] = max(st["max_lsb"], max_lsb)
            st["equal"] = min(st["equal"], equal)
            st["psnr"] = min(st["psnr"], psnr(got[0], want[0]))
            st["dab"] = max(st["dab"], float(np.abs(got[1] - want[1]).max()))
        st["map"] = float(np.abs(outs[mode, "map"]
                                 - outs["f32", "map"]).max())
        precision_stats[mode] = st
        print(f"{mode} session vs f32 session (table clicks of 0, 4, 10 "
              f"hints; frame_delta_stats): max {st['max_lsb']} LSB, "
              f"{st['equal']:.4f} of the pixels equal, PSNR "
              f"{st['psnr']:.2f} dB, max |d output_ab| {st['dab']:.3f}, map "
              f"max |dp| {st['map']:.3e} (bounds: {bar})")
        if (st["max_lsb"] > bar["max_lsb"] or st["equal"] < bar["equal"]
                or st["psnr"] < bar["psnr"] or st["dab"] > bar["dab"]
                or st["map"] > bar["map"]):
            die(f"{mode} session is outside its bounds against f32: {st}")
    mode_ms = {mode: [] for mode in modes}
    for _ in range(2):
        for mode, (pm, _pd) in modes.items():
            mode_ms[mode].append(host_ms(
                lambda: pm.net_forward_table(*tables[-1]), 20))
    line = []
    for mode, (pm, _pd) in modes.items():
        t = np.concatenate(mode_ms[mode])
        events, per_click, wall_ms = device_profile(
            lambda: pm.net_forward_table(*tables[-1]), 5)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        conv_us = sum(e.self_device_time_total for e in events
                      if any(tag in e.key for tag in
                             ("conv", "gemm", "dgrad", "xmma", "cutlass",
                              "cudnn", "nhwc", "nchw"))) / 5
        line.append(f"{mode}: p50 {np.percentile(t, 50):.3f} ms, p95 "
                    f"{np.percentile(t, 95):.3f} ms, device busy "
                    f"{busy_ms / 5:.3f} ms per click, of it conv and layout "
                    f"kernels {conv_us / 1e3:.3f} ms, {per_click:.0f} "
                    f"kernels")
    print("captured table click by precision (host clock, frame read back, "
          "40 clicks each in turns of 20): " + "; ".join(line))

    # 9. the async getters, then the engines, with the launch counts read
    # around them: InteractiveSession, StreamingSession and the batch
    # functions (phase 10) are the third path
    ab = np.zeros((2, S, S), np.float32)
    mask = np.zeros((1, S, S), np.float32)
    hints.put_point(ab, mask, [50, 60], 4, [30.0, -20.0])
    torch.backends.cudnn.deterministic = True
    try:
        # cm's graphs hold the deterministic kernels: byte for byte
        frame = cm.net_forward(ab, mask).copy()
        full = cm.get_img_fullres()
        finish = cm.get_img_fullres_async()
        finish2 = cm.net_forward_fullres_async(ab, mask)
        cm.net_forward_table(*tables[3])          # the state moves on
        if not (np.array_equal(finish(), full)
                and np.array_equal(finish2(), full)
                and np.array_equal(cm.net_forward_fullres(ab, mask), full)):
            die("an async full-res getter differs from the synchronous one")
        if full.shape != FULLRES_HW + (3,) or \
                not np.array_equal(cm.output_rgb, frame):
            die("net_forward_fullres left another net frame than "
                "net_forward")
    finally:
        torch.backends.cudnn.deterministic = False
    print("async getters: get_img_fullres_async, net_forward_fullres_async "
          "and net_forward_fullres equal get_img_fullres byte for byte, "
          "also after the model's state moved on")

    for k in entries:
        k.launches = 0
    sess = InteractiveSession(cm, depth=4)
    submit_ms, pending_after = [], []
    t0 = time.perf_counter()
    for i in range(40):
        t1 = time.perf_counter()
        sess.submit(*tables[i % len(tables)])
        submit_ms.append((time.perf_counter() - t1) * 1e3)
        # the device is still at work when submit returns
        pending_after.append(not torch.cuda.current_stream().query())
        if i % 4 == 3:
            seq, shown = sess.latest()
    wall = time.perf_counter() - t0
    counters = (sess.frames_submitted, sess.frames_materialized,
                sess.frames_dropped, sess.pending)
    if counters != (40, 10, 30, 0) or seq != 40:
        die(f"InteractiveSession counters {counters}, seq {seq}")
    last = tables[39 % len(tables)]
    mirrors = (cm.input_ab.copy(), cm.input_mask.copy())
    if sum(pending_after) < 30:
        die(f"InteractiveSession.submit: the device had already finished "
            f"after {40 - sum(pending_after)} of 40 submits; submit waits")
    sess.submit(*last, win_args=window)
    _, shown_win = sess.latest()

    def check_interactive():      # after the path's counts are read
        want = cm.net_forward_table(*last)
        if not (np.array_equal(shown, want)
                and np.array_equal(mirrors[0], cm.input_ab)
                and np.array_equal(mirrors[1], cm.input_mask)):
            die("InteractiveSession: the last frame or the hint mirrors are "
                "not the synchronous click's")
        if not (np.array_equal(shown_win,
                               cm.net_forward_table_win(*last, *window))
                and shown_win.shape == (WIN, WIN, 3)):
            die("InteractiveSession: the window frame is not the "
                "synchronous window click's")

    print(f"InteractiveSession: 40 submits, one latest per 4: submitted, "
          f"materialized, dropped, pending = {counters}; submit p50 "
          f"{np.percentile(submit_ms, 50):.3f} ms, max "
          f"{max(submit_ms):.3f} ms on the host clock, device still at "
          f"work after {sum(pending_after)} of 40 submits; 40 submits + 10 "
          f"frames in {wall * 1e3:.1f} ms")

    rng = np.random.default_rng(12)
    gray = [rng.integers(0, 256, (S, S), dtype=np.uint8) for _ in range(8)]
    table = tables[-1]
    dense = k1._planar_plain(*(torch.from_numpy(a) for a in table[:2]),
                             table[2], S).permute(1, 2, 0).numpy()
    fps, stream_runs = {}, {}
    for form in ("table", "dense"):
        for with_dist in (True, False):
            ss = ST.StreamingSession(m.net, size=S, depth=4,
                                     with_dist=with_dist)
            if form == "table":
                ss.set_hint_table(*table)
            else:
                ss.set_hints(dense[..., :2], dense[..., 2:])
            got = []
            for i in range(8):                    # capture, warm up
                ss.submit(gray[i])
            list(ss.drain())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(120):
                r = ss.submit(gray[i % 8])
                if r is not None:
                    got.append(r)
            got.extend(ss.drain())
            fps[form, with_dist] = 120 / (time.perf_counter() - t0)
            if len(got) != 120 or ss.frames_out != 128:
                die(f"StreamingSession gave {len(got)} of 120 frames")
            stream_runs[form, with_dist] = (ss, got)

    def check_streaming():        # after the path's counts are read
        for (form, with_dist), (ss, got) in stream_runs.items():
            worst, share = 0, 0.0
            for i in range(8):
                g = torch.from_numpy(gray[i]).to(dev)[None, ..., None]
                if form == "table":
                    want = ST._stream_step_u8_table(
                        ss.net, g, *up(table), size=S, with_dist=with_dist)
                else:
                    want = ST._stream_step_u8(
                        ss.net, g, ss._hint_ab, ss._hint_mask,
                        with_dist=with_dist)
                for j in (i, i + 112):
                    d = np.abs(got[j][0].astype(int)
                               - want[0].cpu().numpy().astype(int)).max(-1)
                    worst = max(worst, int(d.max()))
                    share = max(share, float(np.mean(d != 0)))
                    if (want[1] is None) != (got[j][1] is None):
                        die("StreamingSession: with_dist not respected")
                    if with_dist and float((got[j][1] - want[1]).abs().max()
                                           ) > MAP_BOUND:
                        die("StreamingSession: a frame's map differs from "
                            "the direct step's")
            if worst > FRAME_BOUND_LSB or share >= FRAME_BOUND_SHARE:
                die(f"StreamingSession ({form} hints, with_dist="
                    f"{with_dist}): {worst} LSB on {share:.2e} of the pixels"
                    f" from the direct step")
            print(f"StreamingSession, {form} hints, with_dist={with_dist}, "
                  f"uint8 frames, depth 4, default precision: 120 frames in "
                  f"order, {fps[form, with_dist]:.1f} frames/s (host clock, "
                  f"frames read back); against the direct step on 16 of "
                  f"them: {worst} LSB on at most {share:.2e} of the pixels"
                  f"{', maps within ' + str(MAP_BOUND) if with_dist else ''}")

    # 10. the batch engine: N = 8 images with a table each against the
    # per-image f32 clicks, and a window of T = 8 frames against the
    # per-frame streaming step
    imgs = np.stack([image(30 + i, S, S) for i in range(8)])
    bx = np.stack([tables[i][0] for i in range(8)])
    vl = np.stack([tables[i][1] for i in range(8)])
    ct = np.array([tables[i][2] for i in range(8)], np.int32)
    batch_out = B.colorize_batch_table(m.net, imgs, bx, vl, ct)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    B.colorize_batch_table(m.net, imgs, bx, vl, ct)
    batch_ms = (time.perf_counter() - t0) * 1e3
    win_frames = np.stack(gray)[..., None]
    window_out = B.stream_window_u8(m.net, win_frames, *table)
    dense_out = B.colorize_batch(m.net, imgs)
    engine_launches = {k.name: k.launches for k in entries}
    for k in (k1.KERNEL, k1.KERNEL_BATCH, k2.KERNEL, k2.KERNEL_AB,
              k2.KERNEL_BATCH):
        if engine_launches[k.name] == 0:
            die(f"kernel {k.name} was not launched on the engines' path")
    check_interactive()
    print("InteractiveSession: last frame, window frame and hint mirrors "
          "equal the synchronous clicks' (graphs captured with "
          "deterministic convolutions)")
    check_streaming()
    clicks_out = []
    for i in range(8):
        m.set_image(imgs[i])
        clicks_out.append(m.net_forward_table(bx[i], vl[i], ct[i]).copy())
    b_lsb, b_equal = B.frame_delta_stats(batch_out, np.stack(clicks_out))
    steps_out = np.stack([ST._stream_step_u8_table(
        m.net, torch.from_numpy(win_frames[t:t + 1]).to(dev), *up(table),
        size=S, with_dist=False)[0].cpu().numpy() for t in range(8)])
    w_lsb, w_equal = B.frame_delta_stats(window_out, steps_out)
    if (batch_out.shape != (8, S, S, 3) or window_out.shape != (8, S, S, 3)
            or dense_out.shape != (8, S, S, 3)
            or not np.array_equal(dense_out[0], batch_out[0])):
        die("batch engine: wrong shapes, or image 0 (no hints) differs "
            "between the table and the dense form")
    if b_lsb > TF32_BOUND["max_lsb"] or b_equal < TF32_BOUND["equal"]:
        die(f"colorize_batch_table N=8 vs the per-image f32 clicks: "
            f"{b_lsb} LSB, {b_equal:.4f} equal")
    # a forward over 8 frames takes other TF32 conv kernels than over 1
    if w_lsb > TF32_BOUND["max_lsb"] or w_equal < TF32_BOUND["equal"]:
        die(f"stream_window_u8 T=8 vs the per-frame step: {w_lsb} LSB, "
            f"{w_equal:.5f} equal")
    print(f"batch engine (default precision): colorize_batch_table N=8 vs "
          f"the per-image f32 table clicks: max {b_lsb} LSB, {b_equal:.4f} "
          f"of the pixels equal (bounds {TF32_BOUND['max_lsb']} LSB, "
          f"{TF32_BOUND['equal']}); one call {batch_ms:.3f} ms on the host "
          f"clock, frames read back; stream_window_u8 T=8 vs the per-frame "
          f"streaming step: max {w_lsb} LSB, {w_equal:.5f} equal; engines' "
          f"path launches {engine_launches}")

    # 11. the kernels line
    kernels = []
    for k in entries:
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"ideepcolor_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": (launches[k.name] + dist_launches[k.name]
                         + engine_launches[k.name]),
            "launches_main_path": launches[k.name],
            "launches_dist_session": dist_launches[k.name],
            "launches_engines": engine_launches[k.name],
            **report[k.name], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    # 12.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
