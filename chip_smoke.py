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
6. one JSON line listing each kernel entry with its launches on the main
   path, its error against the plain version, its time, the plain
   version's, its bound and what sets it, and the shape and plane layout
   those numbers were measured at;
7. last line: {"ok": true, "device": {...}}.

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
    from ideepcolor_tpu_torch.api import ColorizeImageTorch
    from ideepcolor_tpu_torch.ops import colorspace as cs
    from ideepcolor_tpu_torch.ops import hints
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
    for k in (k2.KERNEL, k2.KERNEL_AB):   # one frame, byte for byte
        report[k.name]["max_abs_err"] = worst[0]
    print(f"K2 compose: max {worst[0]} LSB on {worst[1]:.2e} of the values "
          f"over {len(K2_SIZES)} sizes and {len(layouts)} layouts (bar "
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

    # 6. the kernels line
    kernels = []
    for k in entries:
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"ideepcolor_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces, "launches": launches[k.name],
            **report[k.name], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    # 7.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
