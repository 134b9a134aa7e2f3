#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ideepcolor_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
(the kernels are built for sm_90a) and the CUDA toolkit. Phases, one line
or more each; any failure exits non-zero:

1. environment: Python, torch and CUDA versions, and the card's name and
   power limit as nvidia-smi reports them;
2. build: both kernels from ideepcolor_tpu_torch/csrc, one nvcc each, in
   parallel, timed;
3. K1 (hint rasterizer) against its plain version on the card, bit-exact,
   at S=256 with 200 live hints (overlapping, across the edges), then timed
   at the main path's table;
4. K2 (Lab -> uint8 compose) against its plain version on the card, <= 1
   LSB on < 1e-3 of the pixels, at the click frame, the main path's
   full-res frame and 1536x2048, in each plane layout the main path hands
   it (planar ab, stride-2 ab views, stride-0 zero planes), timed;
5. the main path: ColorizeImageTorch(Xd=256) with the bundled full-width
   teacher weights -- load a seeded 1000x750 image, a table click with no
   hint, ten clicks that add hints, a dense click, the full-res, mask and
   sup full-res getters -- with both kernels' launch counts read around
   it; the same session on the CPU (plain kernel versions, CPU convs) must
   give the same frames within the bound below (1 LSB on < 1e-3 of the
   pixels of each frame); a profile of five clicks says where the device
   time goes;
6. one JSON line listing each kernel with its launches on the main path,
   its error against the plain version, its time, the plain version's,
   its bound and what sets it;
7. last line: {"ok": true, "device": {...}}.

Times are device times from CUDA events: a kernel's ``ms`` and the plain
version's ``plain_ms`` are the median over 50 replays of a CUDA graph of 20
calls, divided by 20. ``bound_ms`` is the larger of the bytes the function
must move over 3.35 TB/s and its operations over 67 TFLOP/s (the H100 SXM
data sheet's HBM rate and f32 rate outside the tensor cores; the int32
compares of K1 are counted at the f32 rate). No single PyTorch call
computes either function, so ``library_ms`` is null.
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
S = 256
FULLRES_HW = (1000, 750)
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


def bound(nbytes: float, ops: float) -> tuple[float, str]:
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


def k1_table(n_live: int, seed: int = 1):
    """A 256-slot table: n_live overlapping boxes, many across the edges."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((256, 4), np.int32)
    values = np.zeros((256, 2), np.float32)
    for i in range(256):
        y, x = rng.integers(-10, S + 10, 2)
        r = rng.integers(0, 13)
        boxes[i] = [y - r, x - r, y + r, x + r]
        values[i] = rng.uniform(-100, 100, 2)
    return boxes, values, n_live


def k1_scanned(boxes, count: int) -> int:
    """Slots K1 scans for this table: from count-1 down to the first box
    that covers the pixel, or all count slots where none does."""
    ys, xs = np.mgrid[0:S, 0:S]
    last = np.full((S, S), -1)
    for k in range(count):
        y1, x1, y2, x2 = boxes[k]
        last[(ys >= y1) & (ys <= y2) & (xs >= x1) & (xs <= x2)] = k
    return int(np.where(last >= 0, count - last, count).sum())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the card",
              file=sys.stderr)
        return 1
    from ideepcolor_tpu_torch.api import ColorizeImageTorch
    from ideepcolor_tpu_torch.ops import hints
    from ideepcolor_tpu_torch.ops.cuda import build
    from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as k2
    from ideepcolor_tpu_torch.ops.cuda import hints_kernel as k1
    dev = torch.device("cuda")

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
    secs = build.build_all([k1.KERNEL, k2.KERNEL])
    print(f"build: {secs:.1f} s for {k1.KERNEL.source}, {k2.KERNEL.source}")
    for k in (k1.KERNEL, k2.KERNEL):
        for line in k.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {k.source}: {line.strip()}")

    report = {}

    # 3. K1: bit-exact at 200 live hints, then timed at the main path's table
    def k1_pair(table):
        b = torch.from_numpy(table[0]).to(dev)
        v = torch.from_numpy(table[1]).to(dev)
        kern = lambda: k1.rasterize_hints_planar(b, v, table[2], S)  # noqa
        def plain():
            ab, mask = hints.rasterize_hints(b, v, table[2], S)
            return torch.cat([ab, mask], -1).permute(2, 0, 1)
        return kern, plain

    kern, plain = k1_pair(k1_table(200))
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        die(f"K1 differs from its plain version (max |d| {err})")
    print(f"K1 check: S={S}, 200 live hints: bit-exact with the plain "
          f"version")
    for label, table in (("200 hints", k1_table(200)),
                         ("main path, 10 hints",
                          hints.points_json_to_table(session_hints(10), S))):
        kern, plain = k1_pair(table)
        n = table[2]
        nbytes = n * 24 + 4 + 3 * S * S * 4
        b_ms, b_by = bound(nbytes, 4 * k1_scanned(table[0], n))
        ms, p_ms, e_ms = device_ms(kern), device_ms(plain), eager_ms(kern)
        print(f"K1 time ({label}): kernel {ms:.5f} ms, plain {p_ms:.5f} ms,"
              f" eager call {e_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by}), "
              f"share of bound {b_ms / ms:.3f}")
    report["rasterize_hints"] = dict(max_abs_err=err, ms=ms, plain_ms=p_ms,
                                     bound_ms=b_ms, bound_by=b_by)

    # 4. K2: <= 1 LSB on < 1e-3 of the pixels, at three frame sizes
    rng = np.random.default_rng(2)
    for H, W in ((S, S), FULLRES_HW, (1536, 2048)):
        lab = torch.from_numpy(np.concatenate(
            [rng.uniform(0, 100, (H, W, 1)),
             rng.uniform(-110, 110, (H, W, 2))],
            -1).astype(np.float32)).to(dev)
        ab = lab[..., 1:].permute(2, 0, 1).contiguous()  # planar, as the U-Net
        l = lab[..., 0]                                  # strided, as Lab
        kern = lambda: k2.lab_to_rgb_u8_hwc(l, ab[0], ab[1])  # noqa: E731
        plain = lambda: k2.lab_to_rgb_u8_plain(l, ab[0], ab[1])  # noqa
        zero = torch.zeros((), device=dev).expand(H, W)  # stride 0
        layouts = {
            # planar ab (the U-Net's output), L at stride 3 (a Lab channel)
            "planar ab": (kern, plain),
            # stride-2 ab views of an (H, W, 2) zoom output (full-res, sup)
            "interleaved ab": (
                lambda: k2.compose_frame_u8(lab[..., :1], lab[..., 1:]),
                lambda: k2.lab_to_rgb_u8_plain(l, lab[..., 1], lab[..., 2])),
            # stride-0 zero ab planes (mask and gray getters)
            "zero ab": (lambda: k2.lab_to_rgb_u8_hwc(l, zero, zero),
                        lambda: k2.lab_to_rgb_u8_plain(l, zero, zero)),
        }
        worst, share = 0, 0.0
        for layout, (run_k, run_p) in layouts.items():
            d = (run_k().int() - run_p().int()).abs()
            torch.cuda.synchronize()
            w, s = int(d.max()), float((d != 0).float().mean())
            if w > 1 or s >= 1e-3:
                die(f"K2 at {H}x{W}, {layout}: {w} LSB on {s:.2e} of the "
                    f"values")
            worst, share = max(worst, w), max(share, s)
        b_ms, b_by = bound(15 * H * W, K2_OPS_PER_PIXEL * H * W)
        ms, p_ms, e_ms = device_ms(kern), device_ms(plain), eager_ms(kern)
        print(f"K2 {H}x{W}: max {worst} LSB on {share:.2e} of the values "
              f"over {len(layouts)} plane layouts; "
              f"kernel {ms:.5f} ms, plain {p_ms:.5f} ms, eager call "
              f"{e_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by}), share of bound "
              f"{b_ms / ms:.3f}")
        if (H, W) == (S, S):
            report["lab_to_rgb_u8"] = dict(max_abs_err=worst, ms=ms,
                                           plain_ms=p_ms, bound_ms=b_ms,
                                           bound_by=b_by)
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

    for k in (k1.KERNEL, k2.KERNEL):
        k.launches = 0
    t0 = time.perf_counter()
    m, gpu, click_s = session(None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in (k1.KERNEL, k2.KERNEL)}
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            m.net_forward_table(*table)
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_device = sorted((e for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA),
                       key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    print(f"profile of 5 table clicks: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms (share {busy_ms / wall_ms:.3f}), "
          f"{len(on_device)} distinct device activities")
    for e in on_device[:12]:
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
    for k in (k1.KERNEL, k2.KERNEL):
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
