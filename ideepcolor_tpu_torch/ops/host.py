"""The port's native host runtime: ctypes bindings to ``native/hostops.cpp``.

Counterpart of ``ideepcolor_tpu/ops/host.py``, with the same public names
and contracts. The C++ source is the port's own copy of the JAX package's,
same symbols and same arithmetic, so the two libraries give the same bytes.
It is the CPU side of a click: the numpy hint mirrors of every table click
(:func:`rasterize_hints`), the host-composed window and ``abq`` frames
(:func:`rgb2lab_u8_ab`, :func:`zoom2_matrices`, :func:`lab2rgb_u8_planar`)
and host Lab conversions (:func:`rgb2lab`). It is not a GPU kernel.

The library is built at first use with ``g++ -O3 -march=native -fopenmp``
into ``build/hostops`` beside the package (never into the package), named
by a hash of the source, the flags and what ``-march=native`` means for
this compiler on this CPU, so a library built for another CPU is never
loaded. A build writes a temporary file and renames it into place, so
processes that build at once each load a whole library. Without ``g++`` on
the machine every function runs its numpy form and :func:`available` says
False; with ``g++`` present, a build or load that fails raises with the
compiler's output. ctypes releases the interpreter lock around each call,
so handler threads run them in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "hostops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hostops"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_checked = False          # get_lib has decided: the library, or None


def library_path(cxx: str) -> Path:
    """Where the library for this source, these flags and this CPU lies."""
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, timeout=60)
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             timeout=60)
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(target.stdout + version.stdout)
    return BUILD_DIR / f"libhostops-{h.hexdigest()[:16]}.so"


def _build(cxx: str) -> Path:
    path = library_path(cxx)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}."
                         f"{threading.get_ident()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ could not build {SRC}:\n{r.stdout}"
                           f"{r.stderr}")
    os.replace(tmp, path)
    return path


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    for name, args in (
            ("rgb2lab_f32", [f32p, f32p, i64]),
            ("rgb2lab_u8f", [u8p, f32p, i64]),
            ("lab2rgb_f32", [f32p, f32p, i64]),
            ("lab2rgb_u8", [f32p, u8p, i64]),
            ("lab2rgb_u8_planar", [f32p, f32p, f32p, u8p, i64]),
            ("rgb2lab_u8_ab_planar", [u8p, f32p, f32p, i64]),
            ("rasterize_hints", [i32p, f32p, i32, i32, i32, f32p, f32p]),
            ("zoom_bilinear_f32", [f32p, i32, i32, i32, f32p, i32, i32]),
            ("zoom2_banded_f32", [f32p, i32, f32p, i32, f32p, f32p, i32,
                                  f32p, f32p])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, None
    lib.num_threads.argtypes, lib.num_threads.restype = [], ctypes.c_int
    return lib


def get_lib():
    """The native library, built and loaded at the first call; None when
    the machine has no ``g++``. Raises if ``g++`` fails to build it or the
    library does not load."""
    global _lib, _checked
    if _checked:
        return _lib
    with _lock:
        if not _checked:
            cxx = shutil.which("g++")
            _lib = None if cxx is None else _bind(_build(cxx))
            _checked = True
    return _lib


def available() -> bool:
    return get_lib() is not None


def _f32(a):
    return np.ascontiguousarray(a, np.float32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# numpy forms (the same published CIE constants as native/hostops.cpp)
_M = np.array([[0.412456439089692, 0.357576077643909, 0.180437483266399],
               [0.212672851405623, 0.715152155287818, 0.072174993306560],
               [0.019333895582329, 0.119192025881303, 0.950304078536368]])
_MINV = np.linalg.inv(_M)
_WHITE = np.array([0.95047, 1.0, 1.08883])
_KAPPA = 24389.0 / 27.0


def _np_rgb2lab(rgb: np.ndarray) -> np.ndarray:
    x = rgb.astype(np.float64)
    lin = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    t = (lin @ _M.T) / _WHITE
    f = np.where(t > 216.0 / 24389.0, np.cbrt(t),
                 (_KAPPA * t + 16.0) / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return np.stack([116 * fy - 16, 500 * (fx - fy), 200 * (fy - fz)],
                    -1).astype(np.float32)


def _np_lab2rgb(lab: np.ndarray) -> np.ndarray:
    L, a, b = (lab.astype(np.float64)[..., i] for i in range(3))
    fy = (L + 16) / 116
    f = np.stack([fy + a / 500, fy, fy - b / 200], -1)
    xyz = np.where(f > 6 / 29, f ** 3, (116 * f - 16) / _KAPPA) * _WHITE
    lin = xyz @ _MINV.T
    srgb = np.where(lin <= 0.0031308, lin * 12.92,
                    1.055 * np.maximum(lin, 0) ** (1 / 2.4) - 0.055)
    return np.clip(srgb, 0, 1).astype(np.float32)


def rgb2lab(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) sRGB in [0,1] -> Lab float32."""
    lib = get_lib()
    rgb = _f32(rgb)
    if lib is None:
        return _np_rgb2lab(rgb)
    out = np.empty_like(rgb)
    lib.rgb2lab_f32(_ptr(rgb, ctypes.c_float), _ptr(out, ctypes.c_float),
                    rgb.size // 3)
    return out


def rgb2lab_u8(rgb_u8: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 sRGB -> Lab float32, exact (the linearization is a
    256-entry table of the uint8 values)."""
    lib = get_lib()
    if lib is None:
        return _np_rgb2lab(rgb_u8.astype(np.float32) / 255.0)
    rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
    out = np.empty(rgb_u8.shape, np.float32)
    lib.rgb2lab_u8f(_ptr(rgb_u8, ctypes.c_uint8), _ptr(out, ctypes.c_float),
                    rgb_u8.size // 3)
    return out


def lab2rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) Lab -> sRGB float32 clipped to [0,1]."""
    lib = get_lib()
    lab = _f32(lab)
    if lib is None:
        return _np_lab2rgb(lab)
    out = np.empty_like(lab)
    lib.lab2rgb_f32(_ptr(lab, ctypes.c_float), _ptr(out, ctypes.c_float),
                    lab.size // 3)
    return out


def lab2rgb_u8(lab: np.ndarray) -> np.ndarray:
    """(..., 3) Lab -> truncated uint8 RGB (the reference's output
    semantics)."""
    lib = get_lib()
    lab = _f32(lab)
    if lib is None:
        return (np.clip(lab2rgb(lab), 0, 1) * 255).astype(np.uint8)
    out = np.empty(lab.shape, np.uint8)
    lib.lab2rgb_u8(_ptr(lab, ctypes.c_float), _ptr(out, ctypes.c_uint8),
                   lab.size // 3)
    return out


def lab2rgb_u8_planar(l: np.ndarray, a: np.ndarray,
                      b: np.ndarray) -> np.ndarray:
    """(H,W) L, a, b planes -> (H,W,3) uint8 RGB, truncated, without an
    interleaved Lab array (the zoom's outputs go in as they are)."""
    shape = a.shape
    l = _f32(l).reshape(shape)
    a = _f32(a)
    b = _f32(b).reshape(shape)
    lib = get_lib()
    if lib is None:
        lab = np.stack([l, a, b], -1)
        return (np.clip(_np_lab2rgb(lab), 0, 1) * 255).astype(np.uint8)
    out = np.empty((*shape, 3), np.uint8)
    lib.lab2rgb_u8_planar(_ptr(l, ctypes.c_float), _ptr(a, ctypes.c_float),
                          _ptr(b, ctypes.c_float), _ptr(out, ctypes.c_uint8),
                          l.size)
    return out


def rasterize_hints(boxes: np.ndarray, values: np.ndarray, count: int,
                    size: int) -> tuple[np.ndarray, np.ndarray]:
    """The hint rasterizer on the host, the contract of ``ops.hints`` and of
    kernel K1: (M,4) int32 inclusive boxes ``[y1,x1,y2,x2]``, (M,2) ab and
    ``count`` live slots -> ab (size,size,2) and mask (size,size,1) f32; a
    later box overwrites an earlier one, boxes are clipped to the frame.
    ``count`` is clamped to [0, M], as K1 clamps it."""
    boxes = np.asarray(boxes).reshape(-1, 4)
    values = np.asarray(values).reshape(-1, 2)
    n = min(max(int(count), 0), len(boxes), len(values))
    boxes = np.ascontiguousarray(boxes[:n], np.int32)
    values = _f32(values[:n])
    lib = get_lib()
    if lib is None:
        ab = np.zeros((size, size, 2), np.float32)
        mask = np.zeros((size, size), np.float32)
        for (y1, x1, y2, x2), v in zip(boxes, values):
            y1, x1 = max(y1, 0), max(x1, 0)
            y2, x2 = min(y2, size - 1), min(x2, size - 1)
            if y1 <= y2 and x1 <= x2:
                ab[y1:y2 + 1, x1:x2 + 1] = v
                mask[y1:y2 + 1, x1:x2 + 1] = 1.0
        return ab, mask[..., None]
    ab = np.empty((size, size, 2), np.float32)
    mask = np.empty((size, size), np.float32)
    lib.rasterize_hints(_ptr(boxes, ctypes.c_int32),
                        _ptr(values, ctypes.c_float), n, size, size,
                        _ptr(ab, ctypes.c_float), _ptr(mask, ctypes.c_float))
    return ab, mask[..., None]


def rgb2lab_u8_ab(rgb_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(H,W,3) uint8 sRGB -> planar (a, b) float32, L skipped: the
    requantized ab of a frame, as the window compose needs it."""
    lib = get_lib()
    if lib is None:
        lab = _np_rgb2lab(rgb_u8.astype(np.float32) / 255.0)
        return (np.ascontiguousarray(lab[..., 1]),
                np.ascontiguousarray(lab[..., 2]))
    rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
    hw = rgb_u8.shape[:-1]
    a = np.empty(hw, np.float32)
    b = np.empty(hw, np.float32)
    lib.rgb2lab_u8_ab_planar(_ptr(rgb_u8, ctypes.c_uint8),
                             _ptr(a, ctypes.c_float), _ptr(b, ctypes.c_float),
                             rgb_u8.size // 3)
    return a, b


def zoom2_matrices(a: np.ndarray, b: np.ndarray, rh: np.ndarray,
                   rw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Two (S,S) planes -> (H,W) each, ``rh @ X @ rw.T``, over only each
    matrix row's nonzero band (the cubic and linear resize matrices have at
    most 4 per row), with double accumulators. The numpy form is the dense
    f32 product; the two agree within f32 rounding."""
    a, b = _f32(a), _f32(b)
    rh, rw = _f32(rh), _f32(rw)
    S = a.shape[0]
    if a.shape != (S, S) or b.shape != (S, S) or rh.ndim != 2 \
            or rw.ndim != 2 or rh.shape[1] != S or rw.shape[1] != S:
        raise ValueError(f"zoom2_matrices: planes {a.shape} {b.shape}, "
                         f"matrices {rh.shape} {rw.shape}")
    lib = get_lib()
    if lib is None:
        return rh @ a @ rw.T, rh @ b @ rw.T
    H, W = rh.shape[0], rw.shape[0]
    oa = np.empty((H, W), np.float32)
    ob = np.empty((H, W), np.float32)
    f = ctypes.c_float
    lib.zoom2_banded_f32(_ptr(rh, f), H, _ptr(rw, f), W, _ptr(a, f),
                         _ptr(b, f), S, _ptr(oa, f), _ptr(ob, f))
    return oa, ob


def zoom_bilinear(x: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """(h,w,c) -> (H,W,c) align-corners bilinear (scipy ``zoom``,
    order=1)."""
    lib = get_lib()
    x = _f32(x)
    h, w, c = x.shape
    if lib is None:
        from scipy.ndimage import zoom
        return zoom(x, (out_hw[0] / h, out_hw[1] / w, 1), order=1
                    ).astype(np.float32)
    out = np.empty((out_hw[0], out_hw[1], c), np.float32)
    lib.zoom_bilinear_f32(_ptr(x, ctypes.c_float), h, w, c,
                          _ptr(out, ctypes.c_float), out_hw[0], out_hw[1])
    return out
