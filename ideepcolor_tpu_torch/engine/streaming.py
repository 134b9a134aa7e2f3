"""Streaming colorization: a grayscale frame stream with persistent hints.

Counterpart of ``ideepcolor_tpu/engine/streaming.py``: the session keeps the
hint tensors on the device and overlaps dispatch with readback. Frame t+1 is
dispatched before frame t's uint8 result is materialized, so steady-state
throughput is bounded by device time, not by the round trip.

The step functions keep the JAX package's layouts at their boundary
(channel-last (1,H,W,C) inputs, (H,W,3) uint8 and (H/4,W/4,529) outputs) and
run the U-Net at ``precision_name="default"`` (TF32 on the card), as the JAX
steps run at ``Precision.DEFAULT``. Every frame is composed by kernel K2; the
table form rasterizes its hints with kernel K1 on every frame. They take the
module (``models.siggraph.as_module``) where the JAX steps take ``params``.

On the card a session runs each step as a captured CUDA graph
(``engine.graphs``): a frame is written into a pinned host buffer, copied to
the step's fixed input buffer, the graph replayed, and the frame's copy to
pinned host memory started behind it.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..device import resolve_device
from ..models.siggraph import as_module
from ..ops import colorspace as cs
from ..ops import hints as oh
from ..ops.cuda import colorspace_kernel as k2
from ..ops.cuda import hints_kernel as k1
from . import graphs


@torch.no_grad()
def _stream_step(net, l_raw, hint_ab, hint_mask, maskcent=0.0,
                 with_dist=True):
    """One stream frame: raw (1,H,W,1) L in [0,100], (1,H,W,2) hint ab and
    (1,H,W,1) hint mask -> (uint8 (H,W,3) frame, the 529-bin suggestion
    distribution at H/4 resolution, (H/4,W/4,529): point lookups at (h//4,
    w//4) equal the reference's x4-nearest-upsampled map). ``with_dist=
    False`` skips the class head entirely and gives None for the map."""
    A = l_raw.permute(0, 3, 1, 2) - 50.0
    B = hint_ab.permute(0, 3, 1, 2)
    M = hint_mask.permute(0, 3, 1, 2)
    if with_dist:
        reg2, dist = net(A, B, M, maskcent, dist=True, dist_lowres=True,
                         precision_name="default")
        ab = reg2 / 110.0                     # undo the dist-mode rescale
        dist = dist[0].permute(1, 2, 0).contiguous()
    else:
        ab = net(A, B, M, maskcent, precision_name="default")
        dist = None
    rgb = k2.lab_to_rgb_u8_hwc(l_raw[0, ..., 0], ab[0, 0], ab[0, 1])
    return rgb, dist


def _l_linear(gray_u8):
    return gray_u8.to(torch.float32) * (100.0 / 255.0)


def _l_srgb(gray_u8):
    g = gray_u8.to(torch.float32) / 255.0
    return cs.rgb_to_lab(torch.cat([g, g, g], -1))[..., :1]


def _stream_step_u8(net, gray_u8, hint_ab, hint_mask, maskcent=0.0,
                    with_dist=True):
    """uint8 gray-frame variant: (1,H,W,1) uint8; the dequantization to L
    in [0,100] happens on the device, so an 8-bit source uploads a quarter
    of the bytes per frame."""
    return _stream_step(net, _l_linear(gray_u8), hint_ab, hint_mask,
                        maskcent, with_dist=with_dist)


def _stream_step_u8_srgb(net, gray_u8, hint_ab, hint_mask, maskcent=0.0,
                         with_dist=True):
    """uint8 sRGB gray-frame variant: the true L* of the gray value, the
    tone curve the reference applies when it loads a grayscale image through
    rgb2lab. For real video sources; the linear ``_stream_step_u8`` is for
    sources that already carry L in [0,100] quantized to 8 bits."""
    return _stream_step(net, _l_srgb(gray_u8), hint_ab, hint_mask, maskcent,
                        with_dist=with_dist)


def _stream_step_u8_table(net, gray_u8, boxes, values, count, maskcent=0.0,
                          size=256, with_dist=True, srgb=False):
    """Tracked-hint variant: the hints arrive as a fixed-shape (MAX_HINTS,
    4) / (MAX_HINTS, 2) table and K1 rasterizes them on the device each
    frame, so hints that move every frame upload ~6 KB, not the dense
    planes. ``count`` is an int, or a one-element int32 device tensor (the
    captured step reads it where it runs)."""
    hints = k1.rasterize_hints_planar(boxes, values, count, size)
    l_raw = _l_srgb(gray_u8) if srgb else _l_linear(gray_u8)
    return _stream_step(net, l_raw, hints[None, :2].permute(0, 2, 3, 1),
                        hints[None, 2:].permute(0, 2, 3, 1), maskcent,
                        with_dist=with_dist)


class StreamingSession:
    """Pipelined hint-persistent colorization of an L-frame stream.

    ``submit(l_frame)`` dispatches asynchronously and returns the OLDEST
    completed frame once the pipeline is primed (``depth`` frames in
    flight, default 4). ``set_hints`` / ``set_hint_table`` swap the
    persistent hints between frames; on the card a captured step copies
    new hints into its own buffers, so no graph is captured again. ``weights`` is the module
    or a state dict (``models.siggraph.as_module``); the session runs on the
    card unless ``device="cpu"``. Single consumer: call ``submit`` /
    ``drain`` from one thread.
    """

    def __init__(self, weights, size: int = 256, maskcent: float = 0.0,
                 depth: int = 4, with_dist: bool = True, device=None):
        self.device = resolve_device(device)
        self.net = as_module(weights, self.device)
        self.size = size
        self.maskcent = float(maskcent)
        self.depth = max(1, depth)
        self.with_dist = with_dist
        dev = self.device
        self._hint_ab = torch.zeros((1, size, size, 2), device=dev)
        self._hint_mask = torch.zeros((1, size, size, 1), device=dev)
        self._table = None
        self._inflight: deque = deque()
        self.frames_in = 0
        self.frames_out = 0
        self._cuda = dev.type == "cuda"
        if self._cuda:
            net = self.net
            bind = lambda step: graphs.GraphProgram(  # noqa: E731
                lambda *a, **kw: step(net, *a, **kw))
            self._steps = {s: bind(s) for s in (
                _stream_step, _stream_step_u8, _stream_step_u8_srgb,
                _stream_step_u8_table)}
            self._stage = None             # the table's, made on first use
            self._frames: dict = {}        # dtype -> (pinned ring, device)

    def _step(self, step, *args, **options):
        if self._cuda:
            return self._steps[step](*args, **options)
        return step(self.net, *args, **options)

    def set_hints(self, hint_ab: np.ndarray, hint_mask: np.ndarray):
        """hint_ab (H,W,2), hint_mask (H,W,1); they persist across
        frames."""
        dev = self.device
        self._hint_ab = torch.as_tensor(
            np.asarray(hint_ab, np.float32), device=dev)[None]
        self._hint_mask = torch.as_tensor(
            np.asarray(hint_mask, np.float32), device=dev)[None]
        self._table = None

    def set_hint_table(self, boxes: np.ndarray, values: np.ndarray,
                       count: int | None = None):
        """Swap hints as an (m,4) int32 box / (m,2) float32 ab table (m <=
        ops.hints.MAX_HINTS), rasterized on the device each frame: the
        cheap way to move hints EVERY frame. uint8-frame submissions
        only (the video path)."""
        boxes = np.asarray(boxes, np.int32).reshape(-1, 4)
        values = np.asarray(values, np.float32).reshape(-1, 2)
        n = len(boxes) if count is None else int(count)
        if n > oh.MAX_HINTS:
            raise ValueError(f"{n} hints > MAX_HINTS={oh.MAX_HINTS}")
        if self._cuda:
            st = self._stage
            if st is None:
                st = self._stage = graphs.TableStage(self.device)
            st.put(boxes[:n], values[:n], n)
            self._table = (st.boxes, st.values, st.count)
            return
        b = np.zeros((oh.MAX_HINTS, 4), np.int32)
        v = np.zeros((oh.MAX_HINTS, 2), np.float32)
        b[:n], v[:n] = boxes[:n], values[:n]
        self._table = (torch.from_numpy(b), torch.from_numpy(v), n)

    def _upload(self, frame: np.ndarray):
        """(H,W) frame -> (1,H,W,1) on the device. On the card: through a
        ring of pinned host buffers (one more than ``depth``, so a buffer is
        rewritten only after the frame that used it has been waited for)
        into one fixed device buffer per dtype, by an asynchronous copy."""
        if not self._cuda:
            return torch.from_numpy(np.ascontiguousarray(frame))[None, ...,
                                                                 None]
        t = torch.from_numpy(np.ascontiguousarray(frame))
        slot = self._frames.get(t.dtype)
        if slot is None or slot[0].shape[1:] != t.shape:
            ring = torch.empty((self.depth + 1,) + t.shape, dtype=t.dtype,
                               pin_memory=True)
            dev = torch.empty((1,) + t.shape + (1,), dtype=t.dtype,
                              device=self.device)
            slot = self._frames[t.dtype] = (ring, graphs.Fixed(dev))
        ring, dev = slot
        host = ring[self.frames_in % len(ring)]
        host.copy_(t)
        dev.t[0, ..., 0].copy_(host, non_blocking=True)
        return dev

    def submit(self, l_frame: np.ndarray, srgb: bool = False):
        """l_frame (H,W): raw L in [0,100] (float), or a uint8 gray frame
        (dequantized to L on the device; with ``srgb=True`` the gray value
        is read as sRGB and converted to true L*). Returns a completed
        (rgb_u8, dist) pair once the pipeline is primed, else None."""
        mc, wd = self.maskcent, self.with_dist
        if getattr(l_frame, "dtype", None) == np.uint8:
            g = self._upload(l_frame)
            if self._table is not None:
                out = self._step(_stream_step_u8_table, g, *self._table,
                                 maskcent=mc, size=self.size, with_dist=wd,
                                 srgb=srgb)
            else:
                step = _stream_step_u8_srgb if srgb else _stream_step_u8
                out = self._step(step, g, self._hint_ab, self._hint_mask,
                                 maskcent=mc, with_dist=wd)
        elif self._table is not None:
            raise ValueError("set_hint_table requires uint8 gray frames "
                             "(use set_hints for float-L submissions)")
        else:
            l = self._upload(np.asarray(l_frame, np.float32))
            out = self._step(_stream_step, l, self._hint_ab,
                             self._hint_mask, maskcent=mc, with_dist=wd)
        rgb, dist = out
        # start the device->host copy now, so materialization later only
        # waits on a transfer already under way; a captured step writes its
        # outputs again on the next frame, so the map that stays on the
        # device is a copy of its own
        if self._cuda and dist is not None:
            dist = dist.clone()
        self._inflight.append((graphs.read_async(rgb), dist))
        self.frames_in += 1
        if len(self._inflight) > self.depth:
            return self._materialize(self._inflight.popleft())
        return None

    def drain(self):
        """Yield all remaining completed frames."""
        while self._inflight:
            yield self._materialize(self._inflight.popleft())

    def _materialize(self, out):
        finish, dist = out
        self.frames_out += 1
        return finish(), dist               # dist stays on the device
