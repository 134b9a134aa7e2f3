"""Video colorization CLI over the pipelined streaming engine.

Counterpart of ``ideepcolor_tpu/apps/video.py``: colorize a grayscale video
or frame folder with persistent user hints, pipelined so throughput is
bound by the device (engine.streaming overlaps dispatch with readback; uint8
gray frames upload 4x fewer bytes and convert to L* on the device). Runs on
the card unless ``--device cpu``.

Input : a directory of image frames (sorted by name; decoded by the port's
        codec: PNG natively, other formats through OpenCV where it is
        installed), or a video file (anything cv2.VideoCapture opens; needs
        OpenCV).
Hints : optional JSON file, a list of {"y", "x", "ab": [a, b], "radius"}
        in net-resolution coordinates (the same schema the HTTP server's
        X-Hints header uses).
Output: a directory of PNG frames (default), or an .avi (MJPG) when
        ``--out`` ends in .avi and OpenCV is installed (else a PNG
        directory of the same stem).

``--track-hints`` moves the hints along Farneback optical flow, which is
OpenCV's (:func:`farneback_flow`). Without OpenCV, a run that needs it (a
video file, tracked hints) exits 2 before any work.

Run: python -m ideepcolor_tpu_torch.apps.video INPUT --out OUT \
         [--weights W] [--hints hints.json] [--size 256] [--fps 30]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..utils.imageio import (UnsupportedImage, encode_png, read_image,
                             rgb_to_gray_u8)
from ..utils.imageio import _cv2 as _opencv


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help="video file or directory of frames")
    ap.add_argument("--out", type=str, default="./colorized",
                    help="output directory of PNGs, or an .avi path")
    ap.add_argument("--weights", type=str, default="",
                    help="checkpoint (.pth/.npz); empty: a seeded net")
    ap.add_argument("--hints", type=str, default="",
                    help="JSON file of hint points (net-res coords)")
    ap.add_argument("--size", type=int, default=256,
                    help="network resolution (frames are resized to it)")
    ap.add_argument("--fps", type=float, default=30.0,
                    help="output fps for .avi output")
    ap.add_argument("--depth", type=int, default=4,
                    help="pipeline depth (frames in flight)")
    ap.add_argument("--maskcent", action="store_true")
    ap.add_argument("--limit", type=int, default=0,
                    help="stop after N frames (0 = all)")
    ap.add_argument("--track-hints", action="store_true",
                    help="advect the hint points along dense optical "
                         "flow so they stick to moving content (hints "
                         "re-rasterize on the device from a ~3 KB table "
                         "each frame); needs OpenCV")
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' to run on the CPU; default: the card")
    return ap.parse_args(argv)


def farneback_flow(prev: np.ndarray, cur: np.ndarray) -> np.ndarray:
    """Dense (H, W, 2) (dx, dy) flow from ``prev`` to ``cur``, (H, W) uint8:
    OpenCV's Farneback at the JAX app's settings."""
    import cv2
    return cv2.calcOpticalFlowFarneback(
        prev, cur, None, pyr_scale=0.5, levels=3, winsize=15, iterations=3,
        poly_n=5, poly_sigma=1.2, flags=0)


class HintTracker:
    """Advect hint points along dense optical flow so user hints stick
    to CONTENT as it moves across frames.

    Flow runs on the host at net resolution; the per-frame hint update
    ships as the fixed-shape table (StreamingSession.set_hint_table, ~3 KB)
    that kernel K1 rasterizes on the device. ``flow`` is the flow function
    (:func:`farneback_flow` by default)."""

    def __init__(self, hints: list, size: int, flow=farneback_flow):
        from ..ops.hints import MAX_HINTS
        self.size = size
        self.flow = flow
        self.hints = [dict(h) for h in hints]
        if len(self.hints) > MAX_HINTS:
            raise ValueError(f"{len(self.hints)} hints > MAX_HINTS="
                             f"{MAX_HINTS}; tracked hints use the fixed "
                             f"table path")
        self.pts = np.array([[float(h["y"]), float(h["x"])]
                             for h in self.hints], np.float32)
        self.prev = None

    def step(self, gray_net):
        """Update positions with the prev->cur flow; return the current
        (boxes, values, count) hint table."""
        from ..ops.hints import points_json_to_table
        if self.prev is not None and len(self.pts):
            flow = self.flow(self.prev, gray_net)
            iy = np.clip(np.round(self.pts[:, 0]).astype(int), 0,
                         self.size - 1)
            ix = np.clip(np.round(self.pts[:, 1]).astype(int), 0,
                         self.size - 1)
            self.pts[:, 0] += flow[iy, ix, 1]
            self.pts[:, 1] += flow[iy, ix, 0]
            np.clip(self.pts, 0, self.size - 1, out=self.pts)
        self.prev = gray_net
        for h, (y, x) in zip(self.hints, self.pts):
            h["y"], h["x"] = int(round(float(y))), int(round(float(x)))
        return points_json_to_table(self.hints, self.size)


def _frame_source(path: str):
    """Yield uint8 gray frames from a frame directory (the port's codec and
    gray conversion) or a video file (OpenCV). A file in the directory that
    is no image is skipped, as cv2.imread skips it; an image only OpenCV
    could decode raises UnsupportedImage where it is not installed."""
    if os.path.isdir(path):
        for n in sorted(os.listdir(path)):
            try:
                rgb = read_image(os.path.join(path, n))
            except UnsupportedImage:
                raise
            except (ValueError, IsADirectoryError):
                continue
            yield rgb_to_gray_u8(rgb)
        return
    import cv2
    cap = cv2.VideoCapture(path)
    try:
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            yield rgb_to_gray_u8(bgr[:, :, ::-1])
    finally:
        cap.release()


class _FrameSink:
    """PNG-directory or MJPG-avi writer. The .avi needs OpenCV and a codec
    that opens; otherwise the frames go to a PNG directory of the same
    stem, and the fallback is printed."""

    def __init__(self, out: str, size: int, fps: float):
        self.n = 0
        self.writer = None
        self.out = out
        if out.endswith(".avi"):
            cv2 = _opencv()
            if cv2 is not None:
                os.makedirs(os.path.dirname(os.path.abspath(out)),
                            exist_ok=True)
                self.writer = cv2.VideoWriter(
                    out, cv2.VideoWriter_fourcc(*"MJPG"), fps, (size, size))
                if not self.writer.isOpened():  # codec unavailable
                    self.writer = None
            if self.writer is None:
                self.out = out[:-4]
                why = ("OpenCV (the cv2 package) is not installed"
                       if cv2 is None else "the MJPG codec did not open")
                print(f"writing PNG frames to {self.out}/: {why}")
        if self.writer is None:
            os.makedirs(self.out, exist_ok=True)

    def write(self, rgb_u8):
        if self.writer is not None:
            self.writer.write(np.ascontiguousarray(rgb_u8[:, :, ::-1]))
        else:
            with open(os.path.join(self.out, f"frame_{self.n:06d}.png"),
                      "wb") as f:
                f.write(encode_png(rgb_u8))
        self.n += 1

    def close(self):
        if self.writer is not None:
            self.writer.release()


def _needs_opencv(args, flow) -> str | None:
    """What of this run needs OpenCV, or None."""
    if not os.path.isdir(args.input):
        return "video file input"
    if args.track_hints and args.hints and flow is farneback_flow:
        return "--track-hints (Farneback optical flow)"
    return None


def run(args, flow=farneback_flow) -> int:
    """Colorize ``args.input``; ``flow`` moves tracked hints (OpenCV's
    Farneback by default). Returns the exit code."""
    import time

    import torch

    from ..engine.streaming import StreamingSession
    from ..models import siggraph
    from ..ops.hints import put_points_json
    from ..ops.resize import resize_u8_half_pixel

    need = _needs_opencv(args, flow)
    if need is not None and _opencv() is None:
        print(f"{need} needs OpenCV (the cv2 package), which is not "
              f"installed; pass a directory of PNG frames"
              + (" and no --track-hints" if "track" in need else ""),
              file=sys.stderr)
        return 2
    sd = (siggraph.load_state_dict_file(args.weights) if args.weights
          else siggraph.init_state_dict(seed=0))
    sess = StreamingSession(sd, size=args.size,
                            maskcent=0.5 if args.maskcent else 0.0,
                            depth=args.depth, with_dist=False,
                            device=args.device)
    tracker = None
    if args.hints:
        with open(args.hints) as f:
            hints = json.load(f)
        if args.track_hints:
            tracker = HintTracker(hints, args.size, flow)
        else:
            ab = np.zeros((2, args.size, args.size), np.float32)
            mask = np.zeros((1, args.size, args.size), np.float32)
            put_points_json(ab, mask, hints, args.size)
            sess.set_hints(ab.transpose(1, 2, 0), mask.transpose(1, 2, 0))
    elif args.track_hints:
        print("--track-hints needs --hints; ignoring")

    sink = _FrameSink(args.out, args.size, args.fps)
    t0 = time.perf_counter()
    t_first = None                 # first completed frame = end of warmup
    n_in = 0
    for gray in _frame_source(args.input):
        if args.limit and n_in >= args.limit:
            break
        g = resize_u8_half_pixel(torch.from_numpy(gray)[..., None],
                                 (args.size, args.size))[..., 0].numpy()
        if tracker is not None:
            boxes, values, count = tracker.step(g)
            sess.set_hint_table(boxes, values, count)
        done = sess.submit(g, srgb=True)
        n_in += 1
        if done is not None:
            if t_first is None:
                t_first = time.perf_counter()
            sink.write(done[0])
    for done in sess.drain():
        if t_first is None:
            t_first = time.perf_counter()
        sink.write(done[0])
    sink.close()
    dt = time.perf_counter() - t0
    # separate the one-off warmup (graph captures, cuDNN's first calls)
    # from the pipelined steady-state rate
    steady = ((sink.n - 1) / max(time.perf_counter() - t_first, 1e-9)
              if t_first is not None and sink.n > 1 else 0.0)
    print(f"colorized {sink.n} frames in {dt:.1f} s "
          f"(warmup {0 if t_first is None else t_first - t0:.1f} s, "
          f"steady {steady:.1f} fps) -> {sink.out}")
    return 0


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
