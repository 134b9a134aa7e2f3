"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``.cu`` source is compiled by ``nvcc`` into a shared library of its own
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). A library may export several entry points, each a
:class:`Kernel` of its own with its own count of launches. Libraries are
built at first use into ``build/kernels`` beside the package, named by a
hash of their sources and flags, so an edited source rebuilds and an
unchanged one is reused. :func:`build_all` starts one ``nvcc`` per missing
library, all at once, and waits for all of them.

Nothing here runs at import: a machine without a card or a CUDA toolkit can
import every module of the port. Asking for a kernel there raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# Hopper's own target (wgmma and setmaxnreg need the "a"). No
# --use_fast_math: K2 picks its cheaper math forms one by one (see its
# source).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "CUDA kernels need nvcc (the CUDA toolkit) and none was found; "
        "run on the CPU by passing CPU tensors / device='cpu'")


# every Kernel made, in order
KERNELS: list["Kernel"] = []

# the thread's capture in progress: {Kernel: launches recorded as nodes}
_RECORDING = threading.local()


@contextlib.contextmanager
def recording_nodes():
    """While a CUDA graph is captured in this thread, count each launch as a
    node of that graph (in the dict yielded, per kernel) and not in
    ``launches``: another thread's launches meanwhile count as usual."""
    nodes = _RECORDING.nodes = {}
    try:
        yield nodes
    finally:
        _RECORDING.nodes = None


class Kernel:
    """One entry point of a hand-written kernel: its source, its C symbol
    and its count of launches. ``launch`` calls the C function, raises on a
    non-zero ``cudaGetLastError()`` and only then adds one to ``launches``.

    A launch made while a CUDA graph is being captured runs nothing: it
    becomes a node of the graph, and the kernel runs once each time the graph
    is replayed. Such a launch is counted as a node of the capture
    (:class:`recording_nodes`), which ``engine.graphs`` adds to ``launches``
    at every replay, so the count stays the number of times the kernel was
    put on the card."""

    def __init__(self, name: str, source: str, symbol: str, argtypes,
                 replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self.ptxas_log = ""
        self._lib = None
        self._fn = None
        KERNELS.append(self)

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for f in sorted(CSRC.glob("*.cuh")) + [CSRC / self.source]:
            h.update(f.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{Path(self.source).stem}-{h.hexdigest()[:16]}.so"

    def _load(self, path: Path) -> None:
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.ideepcolor_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._lib, self._fn = lib, fn

    def load(self) -> "Kernel":
        """Build (if needed) and load the library; raises without nvcc."""
        if self._fn is None:
            build_all([self])
        return self

    def launch(self, *args) -> None:
        code = self.load()._fn(*args)
        if code != 0:
            msg = self._lib.ideepcolor_error_string(code).decode()
            raise RuntimeError(f"{self.name}: launch failed, CUDA error "
                               f"{code}: {msg}")
        nodes = getattr(_RECORDING, "nodes", None)
        if nodes is None:
            self.launches += 1
        else:
            nodes[self] = nodes.get(self, 0) + 1


def build_all(kernels) -> float:
    """Build (one nvcc per library, in parallel) and load every kernel in
    ``kernels`` that is not loaded yet. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [k for k in kernels if k._fn is None]
    jobs = {}
    for k in todo:
        path = k.library_path()
        if path.exists() or path in jobs:
            continue
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / k.source)]
        jobs[path] = (k.source, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failures = []
    for path, (source, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{source}:\n{log}")
            continue
        os.replace(tmp, path)
        path.with_suffix(".log").write_text(log)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    for k in todo:
        path = k.library_path()
        log = path.with_suffix(".log")
        k.ptxas_log = log.read_text() if log.exists() else ""
        k._load(path)
    return time.perf_counter() - t0
