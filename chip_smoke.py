#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ideepcolor_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
(the kernels are built for sm_90a) and the CUDA toolkit. Phases, one line
or more each; any failure exits non-zero:

1. environment: Python, torch and CUDA versions, and the card's name and
   power limit as nvidia-smi reports them;
2. build: both kernel sources of ideepcolor_tpu_torch/csrc (K2's library
   exports the compose and the fused click entry), one nvcc each, in
   parallel, timed;
3. K1 (hint rasterizer) against its plain version on the card, bit-exact,
   at 0, 10, 200 and 256 live hints (overlapping, across the edges) at
   S=256 and at S=250 (not a multiple of 4); timed at the main path's
   table (10 hints) and at 200 hints, with the box tests its tile culling
   leaves beside those of a full scan per pixel;
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
   within 1e-3 of requantized_ab of that frame, timed;
5. the main path: ColorizeImageTorch(Xd=256) with the bundled full-width
   teacher weights -- load a seeded 1000x750 image, a table click with no
   hint, ten clicks that add hints, a dense click, the full-res, mask and
   sup full-res getters -- with every kernel entry's launch count read
   around it; the same session on the CPU (plain kernel versions, CPU
   convs) must give the same frames within the bound below (1 LSB on <
   1e-3 of the pixels of each frame, output_ab within 1e-3 where the
   frames agree); click latency, and a profile of five clicks that says
   where the device time goes and how many device kernels a click runs;
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
7. one JSON line listing each kernel entry with its launches on both paths,
   its error against the plain version, its time, the plain version's, its
   bound and what sets it, and the shape and plane layout those numbers
   were measured at;
8. last line: {"ok": true, "device": {...}}.

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
    from ideepcolor_tpu_torch.engine import pipeline as P
    from ideepcolor_tpu_torch.ops import colorspace as cs
    from ideepcolor_tpu_torch.ops import hints
    from ideepcolor_tpu_torch.ops import kmeans as km
    from ideepcolor_tpu_torch.ops import resize
    from ideepcolor_tpu_torch.ops.cuda import build
    from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as k2
    from ideepcolor_tpu_torch.ops.cuda import hints_kernel as k1
    dev = torch.device("cuda")
    entries = (k1.KERNEL, k2.KERNEL, k2.KERNEL_AB)

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
    for k in (k2.KERNEL, k2.KERNEL_AB):   # one frame, byte for byte
        report[k.name]["max_abs_err"] = worst[0]
    print(f"K2 compose: max {worst[0]} LSB on {worst[1]:.2e} of the values "
          f"over {len(K2_SIZES)} sizes and {len(layouts)} layouts, the "
          f"{WIN}x{WIN} window frame and the 1 x K palettes (bar "
          f"{K2_BAR[0]} LSB on < {K2_BAR[1]})")
    print("library_ms: null for K1 and K2: no single PyTorch call computes "
          "either function")

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
    for name, n in launches.items():
        if n == 0:
            die(f"kernel {name} was not launched on the main path")
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
        events = sorted((e for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
        kernels = sum(e.count for e in events
                      if not e.key.startswith(("Memcpy", "Memset")))
        return events, kernels / n, wall_ms

    events, per_click, wall_ms = device_profile(
        lambda: m.net_forward_table(*table), 5)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    copies = sum(e.count for e in events) / 5 - per_click
    rgb = torch.from_numpy(gpu["click10"]).to(dev)
    _, chain, _ = device_profile(lambda: cs.requantized_ab(rgb), 1)
    print(f"profile of 5 table clicks: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms (share {busy_ms / wall_ms:.3f}), "
          f"{len(events)} distinct device activities; {per_click:.0f} device"
          f" kernels and {copies:.0f} copies per click (the plain "
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
    for name, n in dist_launches.items():
        if n == 0:
            die(f"kernel {name} was not launched on the dist session")

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
        # bound, and byte for byte with the deterministic kernels chosen
        want = dm.net_forward_table(*tables[i])
        d = np.abs(want.astype(int) - dgpu[f"net{i}"].astype(int)).max(-1)
        rerun_share = max(rerun_share, float(np.mean(d != 0)))
        if d.max() > FRAME_BOUND_LSB or np.mean(d != 0) >= FRAME_BOUND_SHARE:
            die(f"dist session: click {i}'s net frame is {d.max()} LSB on "
                f"{np.mean(d != 0):.2e} of the pixels from "
                f"net_forward_table's for the same table")
        torch.backends.cudnn.deterministic = True
        try:
            want = dm.net_forward_table(*tables[i])
            h, w = clicks[i - 1]["y"], clicks[i - 1]["x"]
            if isinstance(dm.net_forward_table_win_suggest(
                    *tables[i], *window, dd, h, w, K=SUGGEST_K), int):
                die(f"dist session: click+suggest click {i} failed on rerun")
            if not np.array_equal(dm.output_rgb, want):
                die(f"dist session: click {i}'s net frame is not "
                    f"net_forward_table's for the same table "
                    f"(deterministic convolutions)")
        finally:
            torch.backends.cudnn.deterministic = False
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
          f"{len(clicks)} net frames byte-identical to net_forward_table's "
          f"with deterministic convolutions, and within 1 LSB on at most "
          f"{rerun_share:.2e} of the pixels with cuDNN's default ones; "
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
    print(f"profile of 5 click+suggest clicks: wall {wall_ms:.3f} ms, device"
          f" busy {busy_ms:.3f} ms (share {busy_ms / wall_ms:.3f}); "
          f"{per_click:.0f} device kernels and {copies:.0f} copies per click")
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

    # 7. the kernels line
    kernels = []
    for k in entries:
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"ideepcolor_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": launches[k.name] + dist_launches[k.name],
            "launches_main_path": launches[k.name],
            "launches_dist_session": dist_launches[k.name],
            **report[k.name], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    # 8.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
