"""HTTP server over the port's colorization engine, on the card.

Counterpart of ``ideepcolor_tpu/apps/serve.py``: the same endpoints, query
parameters, bodies, status codes, ``/stats`` keys and Prometheus names.
Stdlib only (``http.server``), one process per card. Every device call runs
under one :class:`PriorityLock`, so request threads reach the card one at a
time and in the lock's order; captured CUDA graphs are replayed, and made,
only under it. Work that needs no device (decoding the body, encoding the
reply, waiting for a full-res frame's copy to the host) runs outside it.

Endpoints
---------
GET  /healthz      {"status", "device", "size", "requests", ...}
GET  /stats        per-endpoint latency percentiles (newest 1000 requests)
GET  /metrics      the same counters in Prometheus text format
GET  /             the embedded browser UI (``apps/webui.py``)

POST /colorize           body: an image. Optional ``X-Hints`` header: JSON
    list of {"y", "x", "ab": [a, b], "radius"} in Xd-grid coordinates.
    ``?fullres=0`` returns the Xd x Xd frame; ``?model=fast`` serves the
    fast tier (``--student-weights``). With ``--auto-batch N`` concurrent
    ``fullres=0`` requests coalesce into one batched forward.
POST /colorize_batch     body: npz with ``images`` (N,S,S,3) uint8 and
    either dense ``hint_ab`` / ``hint_mask`` or a table (``boxes``,
    ``values``, ``counts``). Reply: npz with ``frames``.
POST /colorize_global    body: npz with ``image`` and ``ref`` (encoded image
    bytes as uint8 arrays): ``image`` colorized under ``ref``'s global ab
    histogram (the Caffe global graph). ``?fullres=0`` for the net-res frame.
POST /session            body: an image; it stays on the card. Reply:
    {"id", "size"}. At most ``MAX_SESSIONS`` (16), least recently used
    evicted first.
POST /session/click?id=X[&fullres=1]     body: the hint list. Reply: PNG.
POST /session/suggest?id=X&h=Y&w=X[&k=K] body: the hint list. Reply:
    {"colors": [[r, g, b] x K], "conf": [K floats]}.
POST /suggest?h=Y&w=X[&k=K]              body: an image (+ ``X-Hints``).
DELETE /session?id=X

Images are decoded and PNG replies encoded by ``utils/imageio.py``: 8-bit PNG
natively, every other format through OpenCV where it is installed; without
it such a body is answered 415.

Where it differs from the JAX server:

* ``warmup`` and ``ready_probe`` capture the serving programs as CUDA graphs
  (there is nothing to compile); ``ready_probe``'s stages are
  ``probe_cuda_init_s``, ``probe_first_dispatch_s`` and
  ``probe_program_load_s``.
* ``health()["device"]`` is the card's name, or ``"cpu"``.
* ``IDEEPCOLOR_NET_CLICK=abq[_half]`` makes net-size session clicks
  ``abq`` clicks (the uint8-quantized ab read back, the frame composed on
  the host), as in the JAX server; full-res session clicks stay ``rgb``.
* ``RecycleGuard.recycle`` releases the card by synchronizing, dropping the
  captured graphs and emptying PyTorch's cache before the exec.
* The service takes ``device`` (the card unless ``"cpu"``); ``main`` takes
  ``--device``. ``use_mesh`` / ``--mesh`` build their mesh from
  ``parallel.mesh.local_devices`` of the service's device type.

Run: ``python -m ideepcolor_tpu_torch.apps.serve --port 8723`` (add
``--device cpu`` to serve from the CPU).
"""

from __future__ import annotations

import argparse
import collections
import copy
import io
import json
import os
import queue
import sys
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np
import torch

from .. import api
from ..device import resolve_device
from ..engine import graphs
from ..engine.batch import colorize_batch, colorize_batch_table
from ..models import global_stats
from ..ops import host
from ..ops.hints import MAX_HINTS, points_json_to_table, put_points_json
from ..ops.resize import resize_u8_half_pixel
from ..parallel import mesh as pmesh
from ..utils.imageio import UnsupportedImage, decode_image, encode_png
from ..utils.profiling import StageTimer
from ..utils.soakload import rss_mb


class ServerBusy(Exception):
    """Bulk admission refused: the bulk queue is at its cap. Handlers map
    this to 429 + Retry-After (backpressure instead of unbounded bulk
    latency under saturation)."""

    def __init__(self, backlog: int, retry_after_s: int):
        super().__init__(f"bulk queue full ({backlog} waiting); "
                         f"retry in ~{retry_after_s}s")
        self.retry_after_s = retry_after_s


class PriorityLock:
    """Two-level device lock: interactive work (session clicks, suggests,
    net-res colorize) is admitted before bulk work (full-res fusion,
    /colorize_batch, global transfer, warmup) regardless of arrival
    order, so a click never queues behind a full-res job that happened to
    arrive first.

    ``with lock:`` acquires at interactive priority; ``with
    lock.bulk():`` at bulk priority. Anti-starvation: after
    ``BULK_BOOST`` consecutive interactive grants while bulk work waits,
    the oldest bulk waiter is admitted (bounds bulk added wait to
    ~BULK_BOOST x one interactive dispatch).
    """

    BULK_BOOST = 6

    def __init__(self):
        self._cv = threading.Condition()
        self._held = False
        self._waiters = (collections.deque(), collections.deque())
        self._streak = 0        # interactive grants while bulk waited
        self.bulk_jumped = 0    # stats: grants that bypassed queued bulk

    def _head(self):
        inter, bulk = self._waiters
        if bulk and (not inter or self._streak >= self.BULK_BOOST):
            return bulk[0]
        return inter[0] if inter else (bulk[0] if bulk else None)

    def bulk_backlog(self) -> int:
        with self._cv:
            return len(self._waiters[1])

    def acquire(self, level: int = 0, cap: int | None = None) -> None:
        me = object()
        with self._cv:
            if level == 1 and cap is not None:
                backlog = len(self._waiters[1])
                if backlog >= cap:
                    # admission check is atomic with enqueue (under _cv),
                    # so the cap is exact, not best-effort
                    raise ServerBusy(
                        backlog, max(1, round(backlog * 0.7)))
            self._waiters[level].append(me)
            while self._held or self._head() is not me:
                self._cv.wait()
            self._waiters[level].remove(me)
            self._held = True
            if level == 0 and self._waiters[1]:
                self._streak += 1
                self.bulk_jumped += 1
            else:
                self._streak = 0

    def release(self) -> None:
        with self._cv:
            self._held = False
            self._cv.notify_all()

    def __enter__(self):
        self.acquire(0)
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def bulk(self, cap: int | None = None):
        return _BulkAcquire(self, cap)


class _BulkAcquire:
    def __init__(self, lock: PriorityLock, cap: int | None = None):
        self._lock = lock
        self._cap = cap

    def __enter__(self):
        self._lock.acquire(1, cap=self._cap)
        return self._lock

    def __exit__(self, *exc):
        self._lock.release()
        return False


class _AutoBatcher:
    """Dynamic request batching: net-res /colorize requests that arrive
    while the device is busy coalesce into ONE batched forward
    (``engine.batch.colorize_batch_table``: K1's batched entry, one forward
    at TF32, K2's batched entry; split over the service's mesh where it has
    one). The collector takes the first queued request, then admits
    whatever else arrives within ``max_wait_ms`` (or until ``max_batch``);
    batches pad to a fixed ladder of bucket sizes, so a bounded set of
    batch shapes ever runs."""

    def __init__(self, service: "ColorizeService", model,
                 max_batch: int = 16, max_wait_ms: float = 5.0):
        self.service = service
        self.model = model          # which net this batcher dispatches
        # (the fast tier gets its own batcher; mixed models cannot share
        # one forward)
        # batch shapes must divide the mesh's batch axes when sharded
        self.align = 1
        if service.mesh is not None:
            self.align = (service.mesh.shape.get("data", 1)
                          * service.mesh.shape.get("dcn", 1))
            if self.align > max(int(max_batch), 1):
                # padding above the configured bound would silently break
                # the user's memory budget: make the conflict loud
                raise ValueError(
                    f"--auto-batch {max_batch} is below the mesh batch "
                    f"alignment {self.align}; raise it or shrink the mesh")
        # dispatch sizes come from a fixed bucket ladder: align-multiples
        # doubling up to max_batch rounded DOWN to the alignment (never
        # above the configured bound, mesh-valid shapes even for
        # non-power-of-two device layouts)
        self.max_batch = max(int(max_batch), 1)
        if self.align == 1:
            self.max_batch = 1 << (self.max_batch.bit_length() - 1)
        else:
            self.max_batch = (self.max_batch // self.align) * self.align
        b, self._buckets = self.align, []
        while b < self.max_batch:
            self._buckets.append(b)
            b *= 2
        self._buckets.append(self.max_batch)
        self.wait_s = float(max_wait_ms) / 1e3
        self.q: queue.Queue = queue.Queue()
        self.dispatches = 0
        self.batched_requests = 0
        threading.Thread(target=self._run, daemon=True,
                         name="serve-autobatch").start()

    def submit(self, rgb_net: np.ndarray, boxes: np.ndarray,
               values: np.ndarray, count: int) -> np.ndarray:
        """Blocks until the coalesced forward completes; returns the
        (S,S,3) uint8 frame for this request. Hints travel as a fixed
        (MAX_HINTS, 4)/(MAX_HINTS, 2) table + live count."""
        ev = threading.Event()
        slot: dict = {}
        self.q.put((rgb_net, boxes, values, count, ev, slot))
        ev.wait()
        if "err" in slot:
            raise slot["err"]
        return slot["frame"]

    def cap_for(self, n: int) -> int:
        """Padded batch size for an n-item batch: the smallest bucket that
        fits (n <= max_batch always holds: the collector stops there)."""
        return next(b for b in self._buckets if b >= n)

    def bucket_caps(self) -> list[int]:
        """Every batch size this batcher can produce (what warmup runs)."""
        return list(self._buckets)

    def _run(self):
        while True:
            items = [self.q.get()]
            deadline = time.monotonic() + self.wait_s
            while len(items) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    items.append(self.q.get(timeout=left))
                except queue.Empty:
                    break
            n = len(items)
            pad = self.cap_for(n) - n
            try:
                imgs = np.stack([it[0] for it in items]
                                + [items[0][0]] * pad)
                boxes = np.stack([it[1] for it in items]
                                 + [items[0][1]] * pad)
                values = np.stack([it[2] for it in items]
                                  + [items[0][2]] * pad)
                counts = np.asarray([it[3] for it in items] + [0] * pad,
                                    np.int32)
                svc = self.service
                with svc.lock, svc.timer.stage("colorize_batched"):
                    svc.requests += n
                    frames = colorize_batch_table(
                        self.model.net, imgs, boxes, values, counts,
                        maskcent=float(self.model.mask_cent),
                        mesh=svc.mesh, device=svc.device)
                self.dispatches += 1
                self.batched_requests += n
                for i, it in enumerate(items):
                    it[5]["frame"] = frames[i]
                    it[4].set()
            except Exception as e:   # propagate to every waiter
                for it in items:
                    it[5]["err"] = e
                    it[4].set()


def _dtype_arg(dtype: str | None):
    """The serving precision as ``prep_net`` takes it: None for f32."""
    return None if dtype in (None, "float32") else dtype


def refuse_processes() -> None:
    """Raise in a run of more than one process (a ``torch.distributed``
    group or a launcher's ``WORLD_SIZE``): the server is one process, and
    two would drive the same cards."""
    n = pmesh.world_size()
    if n > 1:
        raise RuntimeError(f"the server runs as one process, and this run "
                           f"has {n}; start it without a launcher")


class ColorizeService:
    """Model state + request handlers, shared across server threads."""

    def __init__(self, weights: str = '', size: int = 256,
                 maskcent: bool = False, dtype: str | None = "bfloat16",
                 auto_batch: int = 0, glob_weights: str = '',
                 student_weights: str = '', max_bulk_backlog: int = 0,
                 device=None, use_mesh: bool = False):
        """dtype: serving precision, default bfloat16 (the convs on the
        tensor cores; frames within ``BF16_BOUND`` of f32); 'float32' for
        parity serving.

        max_bulk_backlog: bulk-class admission cap -- when that many bulk
        requests (full-res fusion, /colorize_batch, global transfer)
        already wait on the device, further bulk work is shed with 429 +
        Retry-After instead of queueing unboundedly (0 = unbounded).

        device: the card unless "cpu" is asked for; without a card the
        default raises.

        use_mesh: split the bulk batches (``/colorize_batch``, the
        auto-batcher) over a mesh of every local device of the service's
        type (``parallel.mesh.local_devices``), where there is more than
        one.

        The service is one process: it refuses to start in a run of more
        than one (``parallel.mesh.world_size``)."""
        refuse_processes()
        self.device = resolve_device(device)
        self.size = size
        # one staging buffer for every model's clicks: the graphs are
        # captured on its addresses, so all sessions (shallow copies of a
        # model) and tiers replay the same graph per click signature
        self._stage = (graphs.TableStage(self.device)
                       if self.device.type == "cuda" else None)
        self.model = self._model(weights, maskcent, dtype)
        # optional fast tier: a reduced-width student (width is implicit
        # in its checkpoint) served at ?model=fast
        self.model_fast = (self._model(student_weights, maskcent, dtype)
                           if student_weights else None)
        self.lock = PriorityLock()
        self.max_bulk_backlog = int(max_bulk_backlog)
        self.shed_429 = 0           # bulk requests refused at the cap
        self._shed_lock = threading.Lock()
        # drain-and-recycle state (RecycleGuard): while draining, handlers
        # shed new POSTs with 503 and the guard waits for inflight == 0
        self.draining = False
        self.inflight = 0
        self._inflight_cv = threading.Condition()
        self.requests = 0
        self._weights = weights
        self._maskcent = maskcent
        self._dtype = dtype
        self._dist = None            # built lazily on first /suggest
        self._dist_init_lock = threading.Lock()
        self._glob = None            # built lazily on first /colorize_global
        self._sessions: dict = {}    # interactive sessions, LRU order
        self._pending_sessions: dict = {}   # recycle-parked (lazy replay)
        # the global graph is a separate weight family (the Caffe
        # global-hints net), so it takes its own checkpoint; '' = seeded
        self._glob_weights = glob_weights
        self.timer = StageTimer(maxlen=1000)
        self.boot_stages: dict = {}   # filled by main(); in /healthz
        self.mesh = None
        if use_mesh:
            devs = pmesh.local_devices(self.device.type)
            if len(devs) > 1:
                self.mesh = pmesh.make_mesh(devices=devs)
        self.batcher = (_AutoBatcher(self, self.model,
                                     max_batch=auto_batch)
                        if auto_batch > 0 else None)
        self.batcher_fast = (
            _AutoBatcher(self, self.model_fast, max_batch=auto_batch)
            if auto_batch > 0 and self.model_fast is not None else None)

    def _adopt(self, m):
        """Give a model the service's staging buffer (on the card)."""
        if self._stage is not None:
            m._stage = self._stage
        return m

    def _model(self, weights: str, maskcent: bool, dtype):
        m = api.ColorizeImageTorch(Xd=self.size, maskcent=maskcent,
                                   device=self.device)
        m.prep_net(path=weights, dtype=_dtype_arg(dtype))
        return self._adopt(m)

    def _bulk(self):
        """Bulk-priority device acquisition with the admission cap
        (ServerBusy raises from __enter__ and maps to 429)."""
        return self.lock.bulk(self.max_bulk_backlog or None)

    def _count_shed(self):
        with self._shed_lock:
            self.shed_429 += 1

    def _hint_planes(self, hints):
        ab = np.zeros((2, self.size, self.size), np.float32)
        mask = np.zeros((1, self.size, self.size), np.float32)
        put_points_json(ab, mask, hints, self.size)
        return ab, mask

    def _resize_net(self, rgb: np.ndarray) -> np.ndarray:
        """cv2.resize(rgb, (size, size)) on the host, bit for bit."""
        return resize_u8_half_pixel(torch.from_numpy(rgb),
                                    (self.size, self.size)).numpy()

    # -- single image --
    def colorize(self, img_bytes: bytes, hints=None,
                 fullres: bool = True, fast: bool = False) -> bytes:
        if fast and self.model_fast is None:
            raise ValueError("no fast tier: start with --student-weights")
        model = self.model_fast if fast else self.model
        batcher = self.batcher_fast if fast else self.batcher
        rgb = decode_image(img_bytes)
        if not fullres and batcher is not None:
            table = points_json_to_table(hints, self.size)
            if table is not None:     # falls through on >MAX_HINTS hints
                # dynamic batching: coalesce with concurrent net-res
                # requests (the batch counts the request, under the lock);
                # hints ride the table
                result = batcher.submit(self._resize_net(rgb), *table)
                return encode_png(result)
        ab, mask = self._hint_planes(hints)
        # full-res fusion holds the device longer -> bulk priority
        # (interactive clicks and suggests go first)
        lock_ctx = self._bulk() if fullres else self.lock
        with lock_ctx, self.timer.stage(
                "colorize_fullres" if fullres else "colorize"):
            self.requests += 1
            model.load_image_array(rgb)
            if fullres:
                finish = model.net_forward_fullres_async(ab, mask)
                if isinstance(finish, int):
                    raise RuntimeError("forward failed")
            else:
                result = model.net_forward(ab, mask)
                if isinstance(result, int):
                    raise RuntimeError("forward failed")
        if fullres:
            # wait for the full-res frame's copy OUTSIDE the device lock:
            # ``finish`` owns its pinned buffer, so the next request's work
            # on the card cannot change it
            with self.timer.stage("fullres_readback"):
                result = finish()
        return encode_png(result)

    # -- suggestions --
    def _check_k(self, k: int) -> None:
        """Client-controlled k -> 400 before any program is made (each k
        is a captured graph of its own)."""
        kmax = api.ColorizeImageTorchDist.MAX_SUGGEST_K
        if not 1 <= k <= kmax:
            raise ValueError(f"k must be in [1, {kmax}], got {k}")

    def suggest(self, img_bytes: bytes, h: int, w: int, k: int = 9,
                hints=None) -> dict:
        if not (0 <= h < self.size and 0 <= w < self.size):
            raise ValueError(f"(h,w) must be in [0,{self.size}), "
                             f"got ({h},{w})")
        rgb = decode_image(img_bytes)
        table = points_json_to_table(hints, self.size)  # validates; None
        self._check_k(k)                                # on overflow
        dist = self._ensure_dist()
        with self.lock, self.timer.stage("suggest"):
            self.requests += 1
            dist.load_image_array(rgb)
            if table is not None:
                # table dist forward + CMF sampling + k-means + palette in
                # one graph replay
                res = dist.suggest_table(*table, h=h, w=w, K=k)
                if isinstance(res, int):         # -1 sentinel, not a tuple
                    raise RuntimeError("suggest forward failed "
                                       "(image or net unset)")
                colors, conf = res
                return {"colors": colors.tolist(),
                        "conf": [float(c) for c in conf]}
            dist.net_forward(*self._hint_planes(hints))
            centers, conf = dist.get_ab_reccs(h=h, w=w, K=k,
                                              return_conf=True)
            # still under the lock: a concurrent /suggest would reload
            # the shared dist model's image before we read its pixel L
            return self._reccs_to_colors(dist, centers, conf, h, w, k)

    def _ensure_dist(self):
        # own lock, not the device lock: the model is built without
        # holding the device; its graphs are captured at their first call,
        # under the device lock
        with self._dist_init_lock:
            if self._dist is None:
                d = api.ColorizeImageTorchDist(Xd=self.size,
                                               maskcent=self._maskcent,
                                               device=self.device)
                # assign only after a successful prep (a bad weights path
                # must not wedge the endpoint; cf. the glob model)
                d.prep_net(path=self._weights, dtype=_dtype_arg(self._dtype))
                self._dist = self._adopt(d)
        return self._dist

    def _reccs_to_colors(self, d, centers, conf, h, w, k) -> dict:
        """The pixel's L from the native host runtime's ``rgb2lab`` of that
        one pixel; the K palette colors composed in one K2 launch on the
        device."""
        L = float(host.rgb2lab(
            d.img_rgb[h, w][None, None].astype(np.float32) / 255.0)[0, 0, 0])
        lab = np.concatenate(
            [np.full((k, 1), L, np.float32),
             np.asarray(centers, np.float32)], axis=1).T[:, :, None]
        colors = api.colorize.lab2rgb_transpose(
            lab[:1], lab[1:], device=d.device).reshape(k, 3)
        return {"colors": colors.tolist(),
                "conf": [float(c) for c in np.asarray(conf)]}

    # -- interactive sessions (image on the device across clicks) --
    MAX_SESSIONS = 16

    def _session_model(self, rgb: np.ndarray, fast: bool):
        """A session's model: a shallow copy shares the weights, the click
        programs (their captured graphs) and the staging buffer;
        load_image_array then replaces all per-image state. Call under the
        device lock."""
        m = copy.copy(self.model_fast if fast else self.model)
        m.load_image_array(rgb)
        m._sess_fast = fast      # tier, for dump/replay across recycle
        return m

    def session_open(self, img_bytes: bytes, fast: bool = False) -> dict:
        if fast and self.model_fast is None:
            raise ValueError("no fast tier: start with --student-weights")
        rgb = decode_image(img_bytes)
        with self.lock, self.timer.stage("session_open"):
            self.requests += 1
            sid = uuid.uuid4().hex[:16]
            self._sessions[sid] = self._session_model(rgb, fast)
            while len(self._sessions) > self.MAX_SESSIONS:
                self._sessions.pop(next(iter(self._sessions)))  # LRU
        return {"id": sid, "size": self.size}

    def dump_sessions(self, path: str) -> int:
        """Persist every live session's identity + source image to one npz
        (the drain step of the RecycleGuard). Device-side state is not
        saved: replay rebuilds it from the image."""
        arrays, meta = {}, {}
        with self.lock:
            # sessions still parked from the previous recycle (lazy
            # replay, never touched this generation) carry over too, but
            # the live sessions take priority and the total is capped at
            # MAX_SESSIONS, so abandoned sessions cannot grow host memory
            # across recycles; the oldest parked entries drop first
            keep_parked = max(self.MAX_SESSIONS - len(self._sessions), 0)
            parked = list(self._pending_sessions.items())
            for sid, (img, fast) in parked[len(parked) - keep_parked:]:
                arrays[sid] = img
                meta[sid] = bool(fast)
            for sid, m in self._sessions.items():
                arrays[sid] = np.asarray(m.img_rgb_fullres)
                meta[sid] = bool(getattr(m, "_sess_fast", False))
        arrays["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), np.uint8)
        with open(path, "wb") as f:
            np.savez(f, **arrays)
        return len(meta)

    def replay_sessions(self, path: str, lazy: bool = False) -> int:
        """Restore sessions dumped by dump_sessions under their ORIGINAL
        ids (clients keep clicking the same /session/click?id=X across a
        recycle).

        ``lazy=True`` (the re-exec boot path) parks each session's image
        host-side in ``self._pending_sessions`` and restores it on first
        touch instead of replaying everything before serving, so the first
        request waits for its own session only."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            with self.lock:
                for sid, fast in meta.items():
                    if fast and self.model_fast is None:
                        fast = False
                    if lazy:
                        self._pending_sessions[sid] = (
                            np.asarray(z[sid]), fast)
                        continue
                    self._sessions[sid] = self._session_model(
                        np.asarray(z[sid]), fast)
                # parked entries obey the same LRU cap as live sessions:
                # newest kept, oldest dropped
                while len(self._pending_sessions) > self.MAX_SESSIONS:
                    self._pending_sessions.pop(
                        next(iter(self._pending_sessions)))
        return len(meta)

    def _lookup_session(self, sid: str):
        """LRU-touch lookup; restores a recycle-parked session on first
        touch. Call with ``self.lock`` (or the bulk lock) HELD."""
        m = self._sessions.pop(sid, None)
        if m is None and sid in self._pending_sessions:
            img, fast = self._pending_sessions.pop(sid)
            m = self._session_model(img, fast)
        if m is None:
            raise LookupError(f"unknown session {sid!r}")
        self._sessions[sid] = m                             # LRU touch
        while len(self._sessions) > self.MAX_SESSIONS:      # restore can
            self._sessions.pop(next(iter(self._sessions)))  # overfill
        return m

    def session_click(self, sid: str, hints, fullres: bool = False
                      ) -> bytes:
        table = points_json_to_table(hints, self.size)
        # fullres session clicks pay the full-res fusion under the lock
        lock_ctx = self._bulk() if fullres else self.lock
        with lock_ctx, self.timer.stage("session_click"):
            self.requests += 1
            # lookup under the lock: a concurrent DELETE or LRU eviction
            # between a pre-lock check and here must be a clean 404
            m = self._lookup_session(sid)
            if table is not None:
                # the frame is read back (or, for full-res, copied from
                # the model's own clone) before the lock is released: the
                # next session's replay overwrites the graph's outputs.
                # IDEEPCOLOR_NET_CLICK=abq[_half] takes the abq click, but
                # not for full-res clicks: the full-res fusion reads the
                # device ab, which abq would upload again at every click.
                # Backends without an abq program return -1: rgb then.
                mode = api.colorize.net_click_mode()
                result = -1
                if mode != "rgb" and not fullres:
                    result = m.net_forward_table_abq(
                        *table, half=(mode == "abq_half"))
                if isinstance(result, int):
                    result = m.net_forward_table(*table)
            else:                       # >MAX_HINTS: dense fallback
                result = m.net_forward(*self._hint_planes(hints))
            if isinstance(result, int):
                raise RuntimeError("forward failed")
            finish = m.get_img_fullres_async() if fullres else None
        if finish is not None:
            # full-res readback outside the lock (stage-timed for /stats)
            with self.timer.stage("fullres_readback"):
                result = finish()
        return encode_png(result)

    def session_suggest(self, sid: str, hints, h: int, w: int,
                        k: int = 9) -> dict:
        """Color recommendations at (h, w) for a session's image, with no
        image upload: the session lazily keeps its own dist-model copy
        (shared weights and graphs) with its Lab planes on the device."""
        if not (0 <= h < self.size and 0 <= w < self.size):
            raise ValueError(f"(h,w) must be in [0,{self.size}), "
                             f"got ({h},{w})")
        table = points_json_to_table(hints, self.size)
        if table is None:
            raise ValueError("too many hints for the suggestion table")
        self._check_k(k)
        self._ensure_dist()
        with self.lock, self.timer.stage("session_suggest"):
            self.requests += 1
            m = self._lookup_session(sid)       # lookup under the lock
            d = getattr(m, "_sess_dist", None)
            if d is None:
                d = copy.copy(self._dist)
                # net-res image only: the suggestion path never touches
                # full-res state
                d.load_image_array(m.img_rgb)
                m._sess_dist = d
            res = d.suggest_table(*table, h=h, w=w, K=k)
            if isinstance(res, int):             # -1 sentinel, not a tuple
                raise RuntimeError("suggest forward failed "
                                   "(image or net unset)")
            colors, conf = res
            return {"colors": colors.tolist(),
                    "conf": [float(c) for c in conf]}

    def session_close(self, sid: str) -> bool:
        with self.lock:
            parked = self._pending_sessions.pop(sid, None) is not None
            return (self._sessions.pop(sid, None) is not None) or parked

    # -- global histogram transfer --
    def colorize_global(self, body: bytes, fullres: bool = True) -> bytes:
        """npz {image, ref} (encoded bytes as uint8 arrays) -> PNG of
        ``image`` colorized under ``ref``'s global ab histogram."""
        try:
            with np.load(io.BytesIO(body)) as z:
                if "image" not in z or "ref" not in z:
                    raise ValueError("npz must contain 'image' and 'ref'")
                img_raw = np.asarray(z["image"], np.uint8)
                ref_raw = np.asarray(z["ref"], np.uint8)
        except ValueError:
            raise
        except Exception as e:          # zipfile/pickle decode errors
            raise ValueError(f"not a valid npz body: {e}")
        rgb = decode_image(img_raw.tobytes())
        # the statistics run at the net size (the 4x4 pool needs sides
        # divisible by 4; the reference's global_stats input is 256^2)
        ref_rgb = self._resize_net(decode_image(ref_raw.tobytes()))
        ab = np.zeros((2, self.size, self.size), np.float32)
        mask = np.zeros((1, self.size, self.size), np.float32)
        with self._bulk(), self.timer.stage("colorize_global"):
            self.requests += 1
            if self._glob is None:
                g = api.ColorizeImageTorchCaffeGlobDist(Xd=self.size,
                                                        device=self.device)
                # assign only after a successful prep: a half-initialized
                # model left behind by a bad --glob-weights path would
                # turn every later request into an opaque 500
                g.prep_net(caffemodel_path=self._glob_weights)
                self._glob = g
            ref = torch.as_tensor(ref_rgb, device=self.device)
            hist = global_stats.extract(
                ref.to(torch.float32) / 255.0)["glob_ab_313"].cpu().numpy()
            self._glob.load_image_array(rgb)
            if fullres:
                finish = self._glob.net_forward_fullres_async(ab, mask,
                                                              hist)
                if isinstance(finish, int):
                    raise RuntimeError("forward failed")
            else:
                result = self._glob.net_forward(ab, mask, hist)
                if isinstance(result, int):
                    raise RuntimeError("forward failed")
        if fullres:
            with self.timer.stage("fullres_readback"):
                result = finish()
        return encode_png(result)

    # -- batch --
    def colorize_batch(self, body: bytes) -> bytes:
        with np.load(io.BytesIO(body)) as z:
            images = z["images"]
            hint_ab = z["hint_ab"] if "hint_ab" in z else None
            hint_mask = z["hint_mask"] if "hint_mask" in z else None
            boxes = z["boxes"] if "boxes" in z else None
            values = z["values"] if "values" in z else None
            counts = z["counts"] if "counts" in z else None
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"images must be (N,S,S,3), got {images.shape}")
        maskcent = float(self.model.mask_cent)
        if boxes is not None:
            # table-hint form: (N,M,4) boxes + (N,M,2) values + (N,)
            # counts, rasterized on the device by K1's batched entry
            if values is None or counts is None:
                raise ValueError("boxes requires values and counts")
            if hint_ab is not None:
                raise ValueError("pass either table or dense hints")
            n = len(images)
            if (boxes.ndim != 3 or boxes.shape[0] != n
                    or boxes.shape[2] != 4
                    or values.shape != (*boxes.shape[:2], 2)
                    or counts.shape != (n,)):
                raise ValueError(
                    f"table shapes mismatch: {boxes.shape} "
                    f"{values.shape} {counts.shape} for {n} images")
            with self._bulk(), self.timer.stage("colorize_batch"):
                self.requests += 1
                frames = colorize_batch_table(
                    self.model.net, images, boxes, values, counts,
                    maskcent=maskcent, mesh=self.mesh, device=self.device)
        else:
            with self._bulk(), self.timer.stage("colorize_batch"):
                self.requests += 1
                frames = colorize_batch(
                    self.model.net, images, hint_ab=hint_ab,
                    hint_mask=hint_mask, maskcent=maskcent, mesh=self.mesh,
                    device=self.device)
        buf = io.BytesIO()
        # uncompressed npz: photo-like uint8 frames barely compress and
        # deflate would cost more than the forward on the response path
        np.savez(buf, frames=frames)
        return buf.getvalue()

    def _gray_png(self) -> bytes:
        return encode_png(np.full((self.size, self.size, 3), 128, np.uint8))

    def ready_probe(self) -> dict:
        """One net-res forward during boot (while handlers still answer
        503-booting): the CUDA context, the first dispatch and the capture
        of the net-res click graph complete before the first client's
        request. Much cheaper than warmup(). Returns the three stages'
        seconds."""
        stages = {}
        t0 = time.time()
        if self.device.type == "cuda":
            torch.cuda.init()
            torch.cuda.get_device_properties(self.device)
        stages["probe_cuda_init_s"] = round(time.time() - t0, 2)
        t0 = time.time()
        (torch.zeros(2, device=self.device) + 1.0).cpu()
        stages["probe_first_dispatch_s"] = round(time.time() - t0, 2)
        t0 = time.time()
        self.colorize(self._gray_png(), None, fullres=False)
        stages["probe_program_load_s"] = round(time.time() - t0, 2)
        return stages

    def warmup(self, suggest: bool = False) -> None:
        """Run every serving program once before admitting traffic: on the
        card this captures each click's CUDA graph (the dense and table
        clicks of each tier, the suggest program at k=9, the global click)
        and runs each auto-batch bucket once, so no request pays a capture.
        On the CPU it runs the same endpoints and captures nothing. Safe to
        call on a live server."""
        body = self._gray_png()
        self.colorize(body, None, fullres=True)
        self.colorize(body, None, fullres=False)
        if self.model_fast is not None:
            self.colorize(body, None, fullres=True, fast=True)
            self.colorize(body, None, fullres=False, fast=True)
        for b in (self.batcher, self.batcher_fast):
            if b is None:
                continue
            for cap in b.bucket_caps():
                imgs = np.full((cap, self.size, self.size, 3), 128,
                               np.uint8)
                with self.lock.bulk():
                    colorize_batch_table(
                        b.model.net, imgs,
                        np.zeros((cap, MAX_HINTS, 4), np.int32),
                        np.zeros((cap, MAX_HINTS, 2), np.float32),
                        np.zeros((cap,), np.int32),
                        maskcent=float(b.model.mask_cent),
                        mesh=self.mesh, device=self.device)
        if suggest:
            self.suggest(body, h=self.size // 2, w=self.size // 2, k=9)
        # the session click path (the table click the GET / UI uses)
        click = [{"y": self.size // 2, "x": self.size // 2,
                  "ab": [20.0, -20.0], "radius": 2}]
        for fast in (False, True) if self.model_fast is not None else (
                False,):
            sid = self.session_open(body, fast=fast)["id"]
            self.session_click(sid, click)
            if api.colorize.net_click_mode() != "rgb":
                # under abq the click above took the abq program; full-res
                # session clicks take the rgb one: capture it too
                self.session_click(sid, click, fullres=True)
            if suggest and not fast:
                self.session_suggest(sid, [], h=self.size // 2,
                                     w=self.size // 2, k=9)
            self.session_close(sid)
        # /colorize_global: its first request otherwise builds the global
        # model and captures its graph while holding the device lock
        gbuf = io.BytesIO()
        np.savez(gbuf, image=np.frombuffer(body, np.uint8),
                 ref=np.frombuffer(body, np.uint8))
        self.colorize_global(gbuf.getvalue())

    def health(self) -> dict:
        return {"status": "draining" if self.draining else "ok",
                "device": (torch.cuda.get_device_name(self.device)
                           if self.device.type == "cuda" else "cpu"),
                "size": self.size, "requests": self.requests,
                "has_fast": self.model_fast is not None,
                "sessions": len(self._sessions),
                "pending_sessions": len(self._pending_sessions),
                "rss_mb": round(rss_mb(), 1),
                "recycle_gen": int(
                    os.environ.get("IDEEPCOLOR_RECYCLE_GEN", "0")),
                "inflight": self.inflight,
                "bulk_backlog": self.lock.bulk_backlog(),
                "shed_429": self.shed_429,
                "boot_stages": self.boot_stages,
                "mesh": (None if self.mesh is None
                         else dict(self.mesh.shape))}

    def release_device(self) -> None:
        """Leave the card idle and hand back what PyTorch caches on it:
        wait for every queued kernel, drop every captured graph (the
        sessions' copies share their programs with the models) and the
        sessions, then empty the allocator's cache. The service captures
        again on its next request."""
        if self.device.type != "cuda":
            return
        with self.lock:
            torch.cuda.synchronize(self.device)
            for m in (self.model, self.model_fast, self._dist, self._glob):
                if m is None:
                    continue
                for v in vars(m).values():
                    if isinstance(v, graphs.GraphProgram):
                        v._cache.clear()
                getattr(m, "_suggest_tbl_cache", {}).clear()
            self._sessions.clear()
            torch.cuda.empty_cache()


class RecycleGuard(threading.Thread):
    """Drain-and-recycle worker-memory guard.

    When the process's VmRSS crosses ``cap_mb`` (a long-lived server's host
    memory grows with fragmentation, pinned buffers and whatever a library
    leaks), the guard (1) stops admitting new POSTs (handlers answer 503 +
    Retry-After), (2) waits for in-flight requests to finish, (3) dumps
    every live session (id + source image) via
    ColorizeService.dump_sessions, (4) releases the card
    (ColorizeService.release_device) and re-execs the worker IN PLACE (same
    pid) with the listening socket kept open across exec -- the kernel
    holds the TCP accept queue, so no connection attempt is refused -- and
    (5) the fresh process replays the sessions under their original ids.

    exec (not fork+exec) means there is never a second process on the card,
    and the drained process has no kernel in flight when it goes.
    """

    def __init__(self, service: ColorizeService,
                 server: ThreadingHTTPServer, cap_mb: float,
                 exec_argv: list, poll_s: float | None = None,
                 dump_path: str | None = None,
                 min_requests: int | None = None):
        super().__init__(daemon=True, name="serve-recycle-guard")
        self.service = service
        self.server = server
        self.cap_mb = float(cap_mb)
        self.exec_argv = list(exec_argv)
        self.poll_s = float(poll_s if poll_s is not None else
                            os.environ.get("IDEEPCOLOR_RECYCLE_POLL_S", 2))
        # exec-loop protection: a cap misconfigured below the process's
        # BASELINE RSS would otherwise recycle forever without serving --
        # require at least this many requests served this generation
        self.min_requests = int(
            min_requests if min_requests is not None else
            os.environ.get("IDEEPCOLOR_RECYCLE_MIN_REQUESTS", 1))
        self.dump_path = dump_path or os.path.join(
            tempfile.gettempdir(),
            f"ideepcolor_sessions_{os.getpid()}.npz")
        self._stop = threading.Event()
        self.rss_peak_mb = 0.0

    def stop(self):
        self._stop.set()

    def run(self):
        # glibc arena slack: freed-but-retained memory that malloc_trim
        # returns to the OS; trimming before each poll read makes the cap
        # trigger on true retention
        try:
            import ctypes
            _trim = ctypes.CDLL("libc.so.6").malloc_trim
        except (OSError, AttributeError):   # non-glibc: skip the trim
            _trim = None
        while not self._stop.wait(self.poll_s):
            if _trim is not None:
                _trim(0)
            rss = rss_mb()
            self.rss_peak_mb = max(self.rss_peak_mb, rss)
            if rss >= self.cap_mb and \
                    self.service.requests >= self.min_requests:
                self.recycle(rss)
                return              # unreachable (exec), defensive

    def recycle(self, rss: float) -> None:
        svc = self.service
        print(f"# recycle: RSS {rss:.0f} MB >= cap {self.cap_mb:.0f} MB; "
              f"draining", file=sys.stderr, flush=True)
        svc.draining = True
        with svc._inflight_cv:
            drained = svc._inflight_cv.wait_for(
                lambda: svc.inflight == 0, timeout=300)
        if not drained:              # pragma: no cover - stuck request
            print(f"# recycle: {svc.inflight} requests still in flight "
                  f"after 300s; recycling anyway", file=sys.stderr)
        n = svc.dump_sessions(self.dump_path)
        gen = int(os.environ.get("IDEEPCOLOR_RECYCLE_GEN", "0")) + 1
        fd = self.server.socket.fileno()
        os.set_inheritable(fd, True)
        os.environ["IDEEPCOLOR_LISTEN_FD"] = str(fd)
        os.environ["IDEEPCOLOR_REPLAY_SESSIONS"] = self.dump_path
        os.environ["IDEEPCOLOR_RECYCLE_GEN"] = str(gen)
        # boot-stage decomposition: lets the new generation report how
        # long the exec + interpreter restart itself took
        os.environ["IDEEPCOLOR_RECYCLE_T0"] = str(time.time())
        print(f"# recycle: gen {gen}, {n} sessions dumped, exec in place",
              file=sys.stderr, flush=True)
        try:
            t0 = time.time()
            svc.release_device()
            print(f"# recycle: device released in "
                  f"{time.time() - t0:.1f}s", file=sys.stderr, flush=True)
        except RuntimeError as e:   # never let the release block the exec
            print(f"# recycle: device release failed "
                  f"({type(e).__name__}: {str(e)[:80]}); exec anyway",
                  file=sys.stderr, flush=True)
        sys.stdout.flush()
        os.execv(self.exec_argv[0], self.exec_argv)


MAX_BODY_BYTES = 512 << 20      # reject absurd uploads before allocating


class _Handler(BaseHTTPRequestHandler):
    service: ColorizeService = None  # injected by attach_service
    boot_t0: float = 0.0             # when the listener opened (booting)
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _booting(self) -> bool:
        """True while the listener accepts but the service is still
        building (prep_net, warmup, session replay after a recycle exec).
        Handlers answer fast 503 + Retry-After instead of letting clients
        wait out the whole boot in the kernel accept queue."""
        return self.service is None

    def _reply_booting(self):
        waited = time.time() - type(self).boot_t0
        self.close_connection = True
        self._err(503, f"worker booting ({waited:.0f}s); retry shortly",
                  {"Retry-After": "2", "Connection": "close"})

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _err(self, code: int, msg: str, headers: dict | None = None):
        body = json.dumps({"error": msg}).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = self.path.split("?")[0]
        if self._booting():
            if path == "/healthz":
                # rss_mb is known even mid-boot: a prober that lands in a
                # recycle's boot window still gets the RSS-vs-cap answer
                self._reply(200, json.dumps(
                    {"status": "booting",
                     "booting_s": round(time.time() - type(self).boot_t0,
                                        1),
                     "rss_mb": round(rss_mb(), 1),
                     "recycle_gen": int(os.environ.get(
                         "IDEEPCOLOR_RECYCLE_GEN", "0"))}).encode(),
                    "application/json")
            else:
                self._reply_booting()
            return
        if path in ("/", "/demo"):
            from .webui import PAGE
            self._reply(200, PAGE.encode(), "text/html; charset=utf-8")
        elif path == "/healthz":
            h = self.service.health()
            h["quiet_disconnects"] = getattr(self.server,
                                             "quiet_disconnects", 0)
            self._reply(200, json.dumps(h).encode(), "application/json")
        elif path == "/stats":
            stats = {"requests": self.service.requests,
                     "latency": self.service.timer.summary(),
                     "lock_bulk_jumped": self.service.lock.bulk_jumped,
                     "bulk_backlog": self.service.lock.bulk_backlog(),
                     "shed_429": self.service.shed_429,
                     "quiet_disconnects": getattr(
                         self.server, "quiet_disconnects", 0)}
            for key, b in (("auto_batch", self.service.batcher),
                           ("auto_batch_fast",
                            self.service.batcher_fast)):
                if b is not None:
                    stats[key] = {
                        "dispatches": b.dispatches,
                        "requests": b.batched_requests,
                        "avg_batch": round(b.batched_requests
                                           / max(b.dispatches, 1), 2)}
            self._reply(200, json.dumps(stats).encode(),
                        "application/json")
        elif path == "/metrics":
            self._reply(200, self._prometheus().encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
        else:
            self._err(404, f"unknown path {self.path}")

    def _prometheus(self) -> str:
        svc = self.service
        h = svc.health()
        lines = [
            "# TYPE ideepcolor_requests_total counter",
            f"ideepcolor_requests_total {svc.requests}",
            "# TYPE ideepcolor_shed_429_total counter",
            f"ideepcolor_shed_429_total {svc.shed_429}",
            "# TYPE ideepcolor_sessions gauge",
            f"ideepcolor_sessions {h['sessions']}",
            "# TYPE ideepcolor_pending_sessions gauge",
            f"ideepcolor_pending_sessions {h['pending_sessions']}",
            "# TYPE ideepcolor_rss_mb gauge",
            f"ideepcolor_rss_mb {h['rss_mb']}",
            "# TYPE ideepcolor_recycle_generation gauge",
            f"ideepcolor_recycle_generation {h['recycle_gen']}",
            "# TYPE ideepcolor_inflight gauge",
            f"ideepcolor_inflight {h['inflight']}",
            "# TYPE ideepcolor_bulk_backlog gauge",
            f"ideepcolor_bulk_backlog {h['bulk_backlog']}",
            "# TYPE ideepcolor_draining gauge",
            f"ideepcolor_draining {1 if svc.draining else 0}",
            "# TYPE ideepcolor_stage_latency_ms summary",
        ]
        for stage, s in sorted(svc.timer.summary().items()):
            for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms")):
                lines.append(
                    f'ideepcolor_stage_latency_ms{{stage="{stage}",'
                    f'quantile="{q}"}} {s[key]:.3f}')
            lines.append(f'ideepcolor_stage_latency_ms_sum'
                         f'{{stage="{stage}"}} '
                         f'{s["mean_ms"] * s["n"]:.3f}')
            lines.append(f'ideepcolor_stage_latency_ms_count'
                         f'{{stage="{stage}"}} {s["n"]}')
        for key, b in (("default", svc.batcher),
                       ("fast", svc.batcher_fast)):
            if b is not None:
                lines.append(f'ideepcolor_autobatch_dispatches_total'
                             f'{{tier="{key}"}} {b.dispatches}')
                lines.append(f'ideepcolor_autobatch_requests_total'
                             f'{{tier="{key}"}} {b.batched_requests}')
        return "\n".join(lines) + "\n"

    def do_DELETE(self):
        if self._booting():
            self._reply_booting()
            return
        path, _, query = self.path.partition("?")
        if path == "/session":
            sid = parse_qs(query).get("id", [""])[0]
            if self.service.session_close(sid):
                self._reply(200, b'{"closed": true}', "application/json")
            else:
                self._err(404, f"unknown session {sid!r}")
        else:
            self._err(404, f"unknown path {path}")

    def do_POST(self):
        if self._booting():
            # shed before reading the body (as in the draining path)
            self._reply_booting()
            return
        svc = self.service
        if svc.draining:
            # recycle in progress: shed before reading the body; close the
            # connection (an unread body would corrupt keep-alive framing)
            self.close_connection = True
            self._err(503, "recycling worker; retry shortly",
                      {"Retry-After": "3", "Connection": "close"})
            return
        with svc._inflight_cv:
            svc.inflight += 1
        try:
            self._do_post_inner()
        finally:
            with svc._inflight_cv:
                svc.inflight -= 1
                svc._inflight_cv.notify_all()

    def _do_post_inner(self):
        path, _, query = self.path.partition("?")
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n > MAX_BODY_BYTES:
                # the unread body would corrupt a keep-alive connection
                # (the next "request line" parses mid-upload) -- close it
                self.close_connection = True
                self._err(413, f"body {n} bytes exceeds {MAX_BODY_BYTES}")
                return
            body = self.rfile.read(n)
            if path == "/colorize":
                hints = None
                if self.headers.get("X-Hints"):
                    hints = json.loads(self.headers["X-Hints"])
                fullres = "fullres=0" not in query
                png = self.service.colorize(body, hints, fullres=fullres,
                                            fast="model=fast" in query)
                self._reply(200, png, "image/png")
            elif path == "/colorize_batch":
                out = self.service.colorize_batch(body)
                self._reply(200, out, "application/x-npz")
            elif path == "/colorize_global":
                png = self.service.colorize_global(
                    body, fullres="fullres=0" not in query)
                self._reply(200, png, "image/png")
            elif path == "/session":
                out = self.service.session_open(
                    body, fast="model=fast" in query)
                self._reply(200, json.dumps(out).encode(),
                            "application/json")
            elif path == "/session/click":
                q = parse_qs(query)
                hints = json.loads(body) if body else []
                sid = q["id"][0]     # missing param -> KeyError -> 400
                try:
                    png = self.service.session_click(
                        sid, hints, fullres="fullres=1" in query)
                except KeyError:
                    raise            # service-internal bug, not a 404
                except LookupError as e:
                    self._err(404, str(e))
                    return
                self._reply(200, png, "image/png")
            elif path == "/session/suggest":
                q = parse_qs(query)
                hints = json.loads(body) if body else []
                sid, h, w = q["id"][0], int(q["h"][0]), int(q["w"][0])
                k = int(q.get("k", ["9"])[0])
                try:
                    out = self.service.session_suggest(sid, hints, h=h,
                                                       w=w, k=k)
                except KeyError:
                    raise
                except LookupError as e:
                    self._err(404, str(e))
                    return
                self._reply(200, json.dumps(out).encode(),
                            "application/json")
            elif path == "/suggest":
                q = parse_qs(query)
                hints = None
                if self.headers.get("X-Hints"):
                    hints = json.loads(self.headers["X-Hints"])
                out = self.service.suggest(
                    body, h=int(q["h"][0]), w=int(q["w"][0]),
                    k=int(q.get("k", ["9"])[0]), hints=hints)
                self._reply(200, json.dumps(out).encode(),
                            "application/json")
            else:
                self._err(404, f"unknown path {path}")
        except ServerBusy as e:
            # bulk-class backpressure: bounded queue instead of unbounded
            # tail latency under saturation
            self.service._count_shed()
            self._err(429, str(e),
                      {"Retry-After": str(e.retry_after_s)})
        except UnsupportedImage as e:
            self._err(415, str(e))
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self._err(400, str(e))
        except Exception as e:  # pragma: no cover - defensive 500
            self._err(500, str(e))


class _QuietDisconnectServer(ThreadingHTTPServer):
    """Client disconnects (reset/broken pipe mid-response) are routine
    under concurrent load; log ONE line instead of a traceback so ops
    output stays parseable, and count them (``quiet_disconnects`` in
    /healthz and /stats). Real handler bugs still get the full traceback.

    The listen backlog is raised from socketserver's default of 5: a
    16-way connect burst (the auto-batch pattern) or a post-recycle
    reconnect stampede overflows a 5-deep SYN queue and the kernel resets
    the excess."""

    request_queue_size = 128
    quiet_disconnects = 0       # per-instance after first increment
    _qd_lock = threading.Lock()  # handle_error runs on handler threads

    def handle_error(self, request, client_address):
        et, _ev = sys.exc_info()[:2]
        if et is not None and issubclass(
                et, (ConnectionResetError, BrokenPipeError, TimeoutError)):
            # counted silently under pytest, one clean line otherwise;
            # locked: += on an attribute is a racy read-modify-write
            with self._qd_lock:
                self.quiet_disconnects += 1
            if not os.environ.get("PYTEST_CURRENT_TEST"):
                print(f"# serve: client {client_address} disconnected "
                      f"({et.__name__})", file=sys.stderr)
        else:
            super().handle_error(request, client_address)


def make_listening_server(port: int = 0, host: str = "127.0.0.1"
                          ) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral) and return a server whose handlers
    answer 503 + Retry-After until :func:`attach_service` installs the
    built ColorizeService. Starting serve_forever() on this BEFORE the
    heavy boot (model load, warmup, replay) gives clients fast retryable
    sheds instead of a wait in the kernel accept queue.

    If IDEEPCOLOR_LISTEN_FD is set (a RecycleGuard re-exec), the already-
    bound listening socket is adopted instead of binding anew -- client
    connections queued in the kernel during the recycle are served, none
    refused."""
    import socket as _socket
    handler = type("BoundHandler", (_Handler,),
                   {"service": None, "boot_t0": time.time()})
    listen_fd = os.environ.pop("IDEEPCOLOR_LISTEN_FD", None)
    if listen_fd is None:
        return _QuietDisconnectServer((host, port), handler)
    srv = _QuietDisconnectServer((host, port), handler,
                                 bind_and_activate=False)
    srv.socket.close()
    srv.socket = _socket.socket(fileno=int(listen_fd))
    srv.server_address = srv.socket.getsockname()
    srv.server_name, srv.server_port = srv.server_address[:2]
    return srv


def attach_service(srv: ThreadingHTTPServer,
                   service: ColorizeService) -> None:
    """Install the service on a listening server -- from this point
    handlers serve instead of answering 503-booting."""
    srv.RequestHandlerClass.service = service


def make_server(port: int = 0, host: str = "127.0.0.1",
                **service_kw) -> ThreadingHTTPServer:
    """Build a ready-to-serve ThreadingHTTPServer (port 0 = ephemeral;
    address in ``server.server_address``). Caller runs serve_forever().
    ``service_kw`` go to :class:`ColorizeService` (``device=None``: the
    card)."""
    srv = make_listening_server(port, host)
    attach_service(srv, ColorizeService(**service_kw))
    return srv


class _SafeStream:
    """stdout/stderr wrapper that swallows write failures: a (possibly
    recycled) worker whose supervisor died -- its stdout pipe closed --
    must keep serving, not die of BrokenPipeError on its next print."""

    def __init__(self, stream):
        self._s = stream

    def write(self, data):
        try:
            return self._s.write(data)
        except OSError:
            return len(data)

    def flush(self):
        try:
            self._s.flush()
        except OSError:
            pass

    def __getattr__(self, name):
        return getattr(self._s, name)


def main(argv=None):
    sys.stdout = _SafeStream(sys.stdout)
    sys.stderr = _SafeStream(sys.stderr)
    p = argparse.ArgumentParser(
        description="ideepcolor HTTP serving on the PyTorch/CUDA port")
    p.add_argument("--port", type=int, default=8723)
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (the default: the card) or 'cpu'")
    p.add_argument("--weights", type=str, default="",
                   help="checkpoint (.pth/.npz); seeded random weights "
                        "when empty")
    p.add_argument("--load_size", type=int, default=256)
    p.add_argument("--pytorch_maskcent", action="store_true")
    p.add_argument("--mesh", action="store_true",
                   help="split /colorize_batch and the auto-batcher over "
                        "every local card (when more than one is visible)")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   help="serving precision (default bfloat16: the convs "
                        "on the tensor cores; pass float32 for parity "
                        "serving)")
    p.add_argument("--auto-batch", type=int, default=0,
                   help="max dynamic batch for net-res /colorize "
                        "(0 = off); concurrent requests coalesce into "
                        "one batched forward")
    p.add_argument("--student-weights", type=str, default="",
                   help="reduced-width student checkpoint served at "
                        "?model=fast (width implicit in the checkpoint)")
    p.add_argument("--glob-weights", type=str, default="",
                   help="checkpoint for the global-hints graph "
                        "(/colorize_global; a separate weight family from "
                        "--weights)")
    p.add_argument("--warmup", action="store_true",
                   help="capture all serving programs (incl. every "
                        "auto-batch bucket and /suggest) before "
                        "accepting traffic")
    p.add_argument("--max-bulk-backlog", type=int, default=32,
                   help="bulk-class admission cap: when this many bulk "
                        "requests (full-res, batch, global) already "
                        "queue, further ones get 429 + Retry-After "
                        "(0 = unbounded)")
    p.add_argument("--rss-cap-mb", type=float, default=0,
                   help="drain-and-recycle the worker (re-exec in place, "
                        "sessions preserved, listener kept open) when "
                        "VmRSS crosses this (0 = off)")
    p.add_argument("--rss-growth-cap-mb", type=float, default=0,
                   help="like --rss-cap-mb but relative: recycle when "
                        "VmRSS grows this much beyond its post-warmup "
                        "baseline")
    args = p.parse_args(argv)
    try:
        refuse_processes()
    except RuntimeError as e:
        raise SystemExit(f"serve: {e}") from None
    from ..config import bundled_weights
    boot_t0 = time.time()
    boot_stages: dict = {}
    # set by the RecycleGuard just before execv: decomposes the exec +
    # interpreter restart cost out of the total boot
    exec_t0 = os.environ.pop("IDEEPCOLOR_RECYCLE_T0", None)
    if exec_t0:
        boot_stages["exec_to_main_s"] = round(boot_t0 - float(exec_t0), 2)
    # out-of-box behavior: fall back to the committed demo checkpoints
    # (weights/README.md) so an unconfigured server colorizes instead of
    # running random weights
    if not args.weights and bundled_weights("teacher"):
        args.weights = bundled_weights("teacher")
        print(f"using bundled demo weights: {args.weights}")
    if not args.student_weights and bundled_weights("student_w05"):
        args.student_weights = bundled_weights("student_w05")
        print(f"fast tier (bundled student): {args.student_weights}")
    # accept IMMEDIATELY (503-booting until the service attaches below)
    srv = make_listening_server(port=args.port, host=args.host)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="serve-accept").start()
    print(f"# accepting (booting) on port {srv.server_address[1]}",
          flush=True)
    boot_stages["accept_open_s"] = round(time.time() - boot_t0, 2)
    service = ColorizeService(
        weights=args.weights, size=args.load_size,
        maskcent=args.pytorch_maskcent, dtype=args.dtype,
        auto_batch=args.auto_batch, glob_weights=args.glob_weights,
        student_weights=args.student_weights,
        max_bulk_backlog=args.max_bulk_backlog, device=args.device,
        use_mesh=args.mesh)
    boot_stages["service_built_s"] = round(time.time() - boot_t0, 2)
    gen0 = os.environ.get("IDEEPCOLOR_RECYCLE_GEN", "0") == "0"
    if args.warmup and gen0:
        # recycled generations skip the full warmup (every capture again
        # would lengthen each recycle's downtime); they capture on demand
        print("warming serving programs ...", flush=True)
        service.warmup(suggest=True)
        print("warmup done")
    else:
        # no full warmup: ONE net-res forward, so the CUDA context, the
        # first dispatch and the net-res click's capture complete BEFORE
        # clients are admitted
        boot_stages.update(service.ready_probe())
    boot_stages["device_ready_s"] = round(time.time() - boot_t0, 2)
    replay = os.environ.pop("IDEEPCOLOR_REPLAY_SESSIONS", None)
    if replay and os.path.exists(replay):
        # lazy: park images host-side and restore each session on first
        # touch, so the first queued client waits for its own session only
        n = service.replay_sessions(replay, lazy=True)
        os.unlink(replay)
        gen = os.environ.get("IDEEPCOLOR_RECYCLE_GEN", "?")
        print(f"# recycle gen {gen}: replayed {n} sessions", flush=True)
    cap = args.rss_cap_mb
    if args.rss_growth_cap_mb > 0:
        prior = os.environ.get("IDEEPCOLOR_RSS_CAP_ABS")
        if prior is not None:
            grown = float(prior)
        else:
            grown = rss_mb() + args.rss_growth_cap_mb  # post-warmup base
            # persist the resolved ABSOLUTE watermark across the recycle
            # exec: a recycled generation re-arming growth from its own
            # (lower, un-warmed) baseline would recycle in a cascade
            os.environ["IDEEPCOLOR_RSS_CAP_ABS"] = str(grown)
        cap = min(cap, grown) if cap > 0 else grown
    if cap > 0:
        # the guard re-execs THIS command line; module form keeps the
        # package's relative imports working after exec
        RecycleGuard(service, srv, cap,
                     [sys.executable, "-m", "ideepcolor_tpu_torch.apps.serve"]
                     + list(argv if argv is not None else sys.argv[1:])
                     ).start()
        print(f"# recycle guard armed: cap {cap:.0f} MB "
              f"(gen {os.environ.get('IDEEPCOLOR_RECYCLE_GEN', '0')})",
              flush=True)
    boot_stages["ready_s"] = round(time.time() - boot_t0, 2)
    service.boot_stages = boot_stages
    attach_service(srv, service)        # from here handlers serve
    print(f"# boot stages: {json.dumps(boot_stages)}", flush=True)
    print(f"serving on http://{srv.server_address[0]}:"
          f"{srv.server_address[1]}  (POST /colorize, /colorize_batch; "
          f"GET /healthz)", flush=True)
    try:
        # the accept loop runs in the daemon thread; park here for signals
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
