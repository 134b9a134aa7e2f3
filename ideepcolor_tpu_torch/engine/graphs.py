"""The click programs as captured CUDA graphs, and what feeds and drains them.

In the JAX package every click is one jitted XLA program
(``ideepcolor_tpu/engine/pipeline.py``): one dispatch whatever the number of
stages. Eager PyTorch launches every stage's kernels one by one, and the host
time between launches, not the device, bounds a click. The counterpart of
"one program" on the card is a CUDA graph: :class:`GraphProgram` wraps a
plain function on tensors, captures it once per signature (after a warm-up
on a side stream) and replays the graph on every later call. On the CPU the
factories of ``engine.pipeline`` return the plain function itself
(:func:`program`); nothing here runs there.

What a graph fixes, and what this module does about it:

* addresses. A graph reads and writes the buffers it was captured with. A
  tensor argument is copied into the program's own input buffer before each
  replay (skipped while the caller passes the same, unmodified tensor: the
  image state and the window's L and matrices change rarely; the program
  holds only a weak reference to it, so a closed session's tensors are
  freed although its model's copies share the program). An argument
  wrapped in :class:`Fixed` is used where it lies and never copied: the
  device twin of :class:`TableStage`, which a click refills in place.
* scalars. A by-value kernel argument or a Python index would be frozen at
  its capture value, so the hint count and the click pixel travel as device
  tensors (``TableStage.count/h/w``): K1's device-count entry and gathers
  by device index read them when the graph runs.
* shapes and static options. Each distinct signature (argument shapes and
  types, keyword options such as K, N, ``map_div``) is a graph of its own,
  kept in a FIFO cache of ``CACHE_MAX`` (8, the bound of the JAX class's
  suggest-program cache).
* random numbers. A ``torch.Generator`` argument is registered with the
  graph, so each replay draws fresh numbers from the generator's current
  state and a re-seeded generator reproduces them.
* kernels chosen. cuDNN's algorithms, TF32 or not, and K2's load modes are
  those of the capture; the mode is part of the function captured.
* outputs. A replay overwrites the previous replay's outputs. The program
  returns its own output buffers: the caller copies (``clone``) what it
  keeps past the next call and may read the rest back at once.
* threads. A capture runs on a stream of its own and neither synchronizes
  the device nor empties a cache, so one thread may capture a program
  (``GraphProgram.prepare``, ahead of its first call) while another
  replays others; the kernel nodes it records are counted per thread.
* garbage. Python's cyclic collector is held off while a graph is
  captured: a collection there may free another graph (a closed session's
  program in a reference cycle), a call the capture does not permit, which
  invalidates it.

No fallback: a capture that fails raises; nothing retries eagerly.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import weakref

import numpy as np
import torch

from ..ops.cuda import build
from ..ops.hints import MAX_HINTS
from ..utils.profiling import annotate, spanned

CACHE_MAX = 8     # graphs a program keeps, FIFO
_WARMUP = 2       # eager runs on a side stream before a capture

# captures in progress in any thread, and whether the collector ran before
_GC_HELD = {"count": 0, "was_enabled": False}
_GC_LOCK = threading.Lock()


@contextlib.contextmanager
def _collector_held():
    """Python's cyclic garbage collector disabled until the last capture
    in progress ends, then as it was before the first."""
    with _GC_LOCK:
        if _GC_HELD["count"] == 0:
            _GC_HELD["was_enabled"] = gc.isenabled()
            gc.disable()
        _GC_HELD["count"] += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _GC_HELD["count"] -= 1
            if _GC_HELD["count"] == 0 and _GC_HELD["was_enabled"]:
                gc.enable()
_RING = 8         # pinned host buffers of a TableStage


class Fixed:
    """A tensor argument that lies at an address of its own for the
    program's whole life and is refilled in place by the caller: the graph
    is captured on it and no copy is made."""

    __slots__ = ("t",)

    def __init__(self, t: torch.Tensor):
        self.t = t


def _signature(a):
    if isinstance(a, Fixed):
        return ("fixed", a.t.data_ptr(), tuple(a.t.shape), a.t.dtype)
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), a.dtype)
    if isinstance(a, torch.Generator):
        return ("generator", id(a))
    raise TypeError(f"a graph program's positional arguments are tensors "
                    f"and generators, got {type(a).__name__}; pass options "
                    f"by keyword")


class _Captured:
    """One captured graph: its input buffers, the arguments last copied into
    them, its outputs and the hand-written kernels it holds as nodes."""

    def __init__(self, graph, bufs, last, outs, nodes):
        self.graph, self.bufs, self.last = graph, bufs, last
        self.outs, self.nodes = outs, nodes


class GraphProgram:
    """``fn(*tensors, **options)`` captured as a CUDA graph per signature.

    Calling it copies the changed arguments into the graph's input buffers,
    replays the graph and returns ``fn``'s outputs as captured: the graph's
    own buffers, valid until the next call with the same signature.
    ``fn`` stays reachable as ``.fn``. ``captures`` and ``replays`` count;
    under a profiler each capture is the span ``graph.capture`` and each
    input copy the span ``graph.copy``."""

    def __init__(self, fn):
        self.fn = fn
        self._cache: dict = {}
        self.captures = 0
        self.replays = 0

    @spanned("graph.capture")
    def _capture(self, args, options) -> _Captured:
        bufs, last = [], []
        for a in args:
            if isinstance(a, Fixed):
                bufs.append(a.t)
            elif isinstance(a, torch.Tensor):
                if a.device.type != "cuda":
                    raise ValueError(f"a graph program takes CUDA tensors, "
                                     f"got one on {a.device}")
                bufs.append(a.clone())
            else:
                bufs.append(a)           # a generator: held, so its id stays
            last.append((weakref.ref(a), a._version)
                        if isinstance(a, torch.Tensor) else None)
        # warm-up and capture on a stream of the capture's own, which waits
        # for the caller's stream once and is waited for once: nothing here
        # synchronizes the device or empties the allocator's caches (as
        # ``torch.cuda.graph`` does), so another thread's clicks go on while
        # a program is captured
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        for a in args:
            if isinstance(a, torch.Generator):
                graph.register_generator_state(a)
        with torch.cuda.stream(side):  # kernels build, cuDNN picks, pools fill
            for _ in range(_WARMUP):
                self.fn(*bufs, **options)
            with build.recording_nodes() as nodes, _collector_held():
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    outs = self.fn(*bufs, **options)
                except BaseException:
                    # leave capture mode; the function's error is raised
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
        current.wait_stream(side)
        self.captures += 1
        return _Captured(graph, bufs, last, outs, list(nodes.items()))

    def _get(self, args, options) -> _Captured:
        key = (tuple(_signature(a) for a in args),
               tuple(sorted(options.items())))
        cap = self._cache.get(key)
        if cap is None:
            cap = self._capture(args, options)
            while len(self._cache) >= CACHE_MAX:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = cap
        return cap

    def prepare(self, *args, **options) -> None:
        """Capture the graph of this signature now, if it is not held yet,
        and replay nothing: ``args`` need only have the shapes, types and
        fixed addresses of the later calls (their values are read by the
        capture's warm-up runs only)."""
        self._get(args, options)

    def __call__(self, *args, **options):
        cap = self._get(args, options)
        for i, a in enumerate(args):
            if not isinstance(a, torch.Tensor):
                continue
            last = cap.last[i]
            if last[0]() is a and last[1] == a._version:
                continue
            with annotate("graph.copy"):
                cap.bufs[i].copy_(a, non_blocking=True)
            cap.last[i] = (weakref.ref(a), a._version)
        cap.graph.replay()
        for k, n in cap.nodes:
            k.launches += n
        self.replays += 1
        return cap.outs


def program(fn, device=None):
    """``fn`` itself for the CPU (or no device); a :class:`GraphProgram` of
    it for a CUDA device."""
    if device is None or torch.device(device).type != "cuda":
        return fn
    return GraphProgram(fn)


class TableStage:
    """A click's small inputs on their way to the card: the hint table
    (``slots`` boxes and values), the live count and the click pixel.

    One device buffer holds them at fixed addresses (``boxes``, ``values``,
    ``count``, ``h``, ``w``: :class:`Fixed` views the graphs are captured
    on). :meth:`put` writes a click's values into one of ``_RING`` pinned
    host buffers and starts one asynchronous copy of it to the device
    buffer, ordered on the stream before the replay that reads it. It waits
    only where the ring has come round to a buffer whose copy, ``_RING``
    puts ago, has not finished."""

    def __init__(self, device):
        slots = self.slots = MAX_HINTS
        nb, nv = slots * 16, slots * 8
        self._host = torch.empty((_RING, nb + nv + 16), dtype=torch.uint8,
                                 pin_memory=True)
        self._np = self._host.numpy()
        self._events: list = [None] * _RING
        self._next = 0
        # zeros: a valid table (no live hint, pixel (0, 0)) before the first
        # put, which a capture ahead of the first click reads in its warm-up
        dev = self._dev = torch.zeros(nb + nv + 16, dtype=torch.uint8,
                                      device=device)
        scalars = dev[nb + nv:].view(torch.int32)
        self.boxes = Fixed(dev[:nb].view(torch.int32).view(slots, 4))
        self.values = Fixed(dev[nb:nb + nv].view(torch.float32)
                            .view(slots, 2))
        self.count = Fixed(scalars[0:1])
        self.h = Fixed(scalars[1:2])
        self.w = Fixed(scalars[2:3])

    def put(self, boxes, values, count, h: int = 0, w: int = 0) -> None:
        i = self._next
        self._next = (i + 1) % _RING
        if self._events[i] is not None:
            self._events[i].synchronize()
        pack_table(self._np[i], self.slots, boxes, values, count, h, w)
        self._dev.copy_(self._host[i], non_blocking=True)
        event = self._events[i] = torch.cuda.Event()
        event.record()


def pack_table(row: np.ndarray, slots: int, boxes, values, count,
               h: int = 0, w: int = 0) -> None:
    """Write one click's inputs into ``row``, a uint8 buffer of ``slots * 24
    + 16`` bytes in :class:`TableStage`'s layout: ``slots`` int32 boxes,
    ``slots`` f32 values, then int32 ``[count, h, w, 0]``. A table of fewer
    rows is padded with zero (dead) slots, the count clamped to its rows."""
    boxes = np.asarray(boxes, np.int32).reshape(-1, 4)
    values = np.asarray(values, np.float32).reshape(-1, 2)
    m = len(boxes)
    if m > slots or len(values) != m:
        raise ValueError(f"a hint table of {m} boxes and {len(values)} "
                         f"values; at most {slots} of each")
    nb, nv = slots * 16, slots * 8
    row[:nb].view(np.int32).reshape(slots, 4)[:m] = boxes
    row[nb:nb + nv].view(np.float32).reshape(slots, 2)[:m] = values
    row[m * 16:nb] = 0
    row[nb + m * 8:nb + nv] = 0
    row[nb + nv:].view(np.int32)[:] = (min(max(int(count), 0), m),
                                       int(h), int(w), 0)


def read_async(t: torch.Tensor):
    """Start the copy of ``t`` to the host and return a function without
    arguments that waits for it and gives the numpy array.

    On the card the copy goes into pinned host memory on the current stream,
    behind the work that makes ``t``, with an event recorded after it; the
    function waits on that event only and owns its buffer, so nothing the
    caller does to the device state later can change what it returns. On the
    CPU ``t`` already is host memory."""
    if t.device.type != "cuda":
        arr = t.numpy()
        return lambda: arr
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()

    def finish() -> np.ndarray:
        event.synchronize()
        return host.numpy()

    return finish
